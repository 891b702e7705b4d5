"""Mean recall@10 of the judged sample of served answers (one answer of
each of the same users every seed, ``drivers._judged``) against the
exact top-10 of the same measure over the float32 corpus (the benchmark's
plain reference, after the window)."""


def read(run):
    return run.get("recall")
