"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command,
``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``, driven by the files this folder holds for each
configuration (``configs/``), measure family (``families/``), traffic mix
(``traffic/``) and per-layer metric (``metrics/``). It imports neither JAX
nor the JAX package."""
