"""Measurement and audit tools of the port, run as
``python -m two_pass_lanczos_tpu_torch.tools.<name>``.

Counterparts of the JAX package's ``scripts/``: ``sol_bench`` (K7 against
its HBM bound), ``scaling_bench`` (per-step time and nnz/s of the
distributed designs over N processes), ``multihost_smoke`` (the arc-sharded
solver over N processes against a single-process oracle) and
``collective_audit`` (per-step collectives, the partition's nnz balance,
gloo wall times).
"""
