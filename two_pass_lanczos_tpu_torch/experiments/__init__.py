"""Experiment CLIs reproducing the reference's six binaries and three
studies, on the port.

Counterpart of ``two_pass_lanczos_tpu/experiments``: ``tradeoff``,
``dense_tradeoff``, ``scalability``, ``stability``, ``orthogonality``,
``datagen`` (the reference's ``src/bin/``), and ``certificate_study`` and
``reorth_study``. Each accepts the JAX CLI's flags with the same meaning
and writes the JAX CLI's CSV header, column for column, so one argv drives
both. Each runs on the card unless ``--torch-device cpu`` (or
``--cpu-f64``) asks for the CPU; a CUDA device without a card raises.
``--isolate`` keeps the reference's orchestrator/worker process model
(``src/bin/tradeoff.rs:4-7``). On the card the memory columns are the
caching allocator's device peak of each row, reset before it.

Run as ``python -m two_pass_lanczos_tpu_torch.experiments.<name> --help``.
"""
