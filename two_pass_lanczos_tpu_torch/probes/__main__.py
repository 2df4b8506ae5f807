"""``python -m two_pass_lanczos_tpu_torch.probes {gather,stream,stages,pipeline} [--arcs N]``"""

import sys

from two_pass_lanczos_tpu_torch.probes.bench import main

if __name__ == "__main__":
    sys.exit(main())
