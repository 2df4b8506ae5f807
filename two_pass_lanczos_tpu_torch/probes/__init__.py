"""The K14 micro-kernels: the Pallas probes' questions asked of the port's
layout on Hopper.

Counterpart of the JAX package's TPU probes (``scripts/probe_gather.py``
and ``scripts/probe/``), which measured the TPU's gather and streaming
levers. Each probe here is a hand-written CUDA kernel (``csrc/probe_*.cu``)
with a plain PyTorch version in its module and a launch counter in
``ops/kkt_fused.LAUNCHES``:

* :mod:`.gather` (K14a): ``g = tab[idx]``, 4 entries a thread a step,
  from shared memory staged by one bulk copy, through ``__ldg`` or a plain
  load, or from a thread-block cluster's distributed shared memory; int32,
  int16, uint8 and two-level indices;
* :mod:`.stream` (K14b): the arc stream of K7 without its gathers, over
  block shapes, four planes or one interleaved record;
* :mod:`.stages` (K14c): K7's routines in K7's block order with each
  stage switched at compile time, plus extra ALU or gather work per arc,
  and the node walk on a node-sorted signed copy of x_a (``node_sorted``);
* :mod:`.pipeline` (K14d): K7 with its arc stream on a ring of bulk
  copies (TMA) on mbarriers, a producer warp beside the consumer warps,
  and K7's node blocks in a kernel of their own on a forked stream; the
  JAX probe's modes (``full`` bitwise K7, ``stream_only``, ``alu`` N,
  ``arc_only``, ``no_gather``), each bitwise the stage probe's twin.

:mod:`.bench` checks every variant against its plain version and times it
warm and cold-L2 on the card; ``python -m two_pass_lanczos_tpu_torch.probes
{gather,stream,stages,pipeline} [--arcs N]`` prints one JSON record per
variant (and, for ``stages`` and ``pipeline``, :func:`.bench.stage_split`
or :func:`.bench.pipeline_split` on stderr).
"""

from two_pass_lanczos_tpu_torch.probes.bench import (
    RUNS,
    Timer,
    pipeline_split,
    run,
    stage_split,
)
from two_pass_lanczos_tpu_torch.probes.gather import gather
from two_pass_lanczos_tpu_torch.probes.pipeline import pipeline
from two_pass_lanczos_tpu_torch.probes.stages import stages
from two_pass_lanczos_tpu_torch.probes.stream import stream, stream_records

__all__ = ["RUNS", "Timer", "run", "stage_split", "pipeline_split",
           "gather", "stream", "stream_records", "stages", "pipeline"]
