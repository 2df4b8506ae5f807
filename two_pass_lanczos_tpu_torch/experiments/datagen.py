"""Instance-generation CLI (reference ``src/bin/datagen.rs``).

Counterpart of ``two_pass_lanczos_tpu/experiments/datagen.py``, with its
flags and the ``netgen-{arcs}-{rho}-{id}-{cf}-{cq}-{s}`` naming
(``datagen.rs:68-90,109-117``). It runs the native C++ generator
(``cpp/mcfgen``, a C tool of the repository) when it is built, and the
port's deterministic ``models/generator.py`` under ``--python`` or without
the binary. Both write the same ``.dmx``/``.qfc`` format, and the Python
generator's files are byte for byte the JAX package's. No device is used.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
NATIVE = REPO / "cpp" / "mcfgen"


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arcs", type=int, required=True, help="number of arcs m")
    p.add_argument("--rho", type=int, choices=[1, 2, 3], required=True,
                   help="density parameter (prho = 0.25/0.5/0.75)")
    p.add_argument("--instance-id", type=int, default=1,
                   help="instance seed id")
    p.add_argument("--fixed-cost", choices=["a", "b"], default="a",
                   help="cf: high (a) or low (b) fixed costs")
    p.add_argument("--quadratic-cost", choices=["a", "b"], default="a",
                   help="cq: high (a) or low (b) quadratic costs")
    p.add_argument("--scaling", choices=["s", "ns"], default="ns",
                   help="capacity scaling by 0.7 (s) or none (ns)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--python", action="store_true",
                   help="use the Python generator even if cpp/mcfgen exists")
    return p


def main(argv=None) -> int:
    from two_pass_lanczos_tpu_torch.experiments.common import (
        log,
        setup_logging,
    )
    from two_pass_lanczos_tpu_torch.models.generator import (
        generate_mcf_instance,
        instance_basename,
    )

    args = build_parser().parse_args(argv)
    setup_logging()
    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    base = instance_basename(args.arcs, args.rho, args.instance_id,
                             args.fixed_cost, args.quadratic_cost,
                             args.scaling)

    if NATIVE.exists() and not args.python:
        cmd = [str(NATIVE), str(args.arcs), str(args.rho),
               str(args.instance_id), args.fixed_cost, args.quadratic_cost,
               args.scaling, str(outdir)]
        log.info("running native generator: %s", " ".join(cmd))
        subprocess.run(cmd, check=True)
    else:
        log.info("running python generator")
        generate_mcf_instance(
            args.arcs, rho=args.rho, instance_id=args.instance_id,
            cf=args.fixed_cost, cq=args.quadratic_cost, scaling=args.scaling,
            output_dir=outdir)

    for ext in (".dmx", ".qfc"):
        f = outdir / f"{base}{ext}"
        if not f.exists():
            raise SystemExit(f"expected output {f} missing")
        log.info("generated %s (%d bytes)", f, f.stat().st_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
