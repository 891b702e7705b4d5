"""The benchmark's plain reference: the measures in plain PyTorch float32
(TF32 off), the corpus residency worked out again from the corpus, the
exact top-k in blocks, and the comparison that decides ``correct``. It
imports nothing of the program (``repro_torch``) and takes nothing the
program made: it is handed the corpus, the queries and the weights that
the benchmark made, and the program's answers, which it judges."""
