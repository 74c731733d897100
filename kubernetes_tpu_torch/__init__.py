"""kubernetes_tpu_torch: the PyTorch and CUDA port of the batched scheduler.

The JAX package `kubernetes_tpu` is the reference this package is held
against. This package keeps its own copies of everything it needs (it
imports no module of the JAX package and never imports `jax`), and keeps
the reference's layout so each module's counterpart is easy to find:
`api/`, `scheduler/`, `scheduler/plugins/`, `ops/`, `parallel/`,
`serving/`, `utils/`.

Entry points run on the CUDA device unless the caller passes
`device="cpu"`; on the CPU each hand-written kernel's plain PyTorch
version runs in its place.
"""
