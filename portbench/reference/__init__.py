"""The plain reference of the benchmark's indexes, in plain PyTorch.

It imports neither JAX nor the JAX package nor anything of
`recommenders_tpu_torch`, and takes nothing the program made but the
partition a ScaNN index chose (its centroids and which row sits in which
slot of which leaf), which it follows (`PERF.md` says why): it quantizes
the catalog itself, scores in f32 with TF32 off, and folds, probes and
selects by the semantics the configuration states.
"""
