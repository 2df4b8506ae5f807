"""The Lanczos recurrence in plain PyTorch."""

from two_pass_lanczos_tpu_torch.algorithms.block import (
    BlockDecomposition,
    block_padded_f_e1,
    block_pass_one,
    block_pass_two,
    solve_fAb_block,
    solve_fAb_block_jit,
)
from two_pass_lanczos_tpu_torch.algorithms.core import (
    LanczosDecomposition,
    breakdown_tolerance,
    lanczos_recurrence_step,
)
from two_pass_lanczos_tpu_torch.algorithms.chunked import (
    lanczos_pass_one_chunked,
    lanczos_standard_chunked,
)
from two_pass_lanczos_tpu_torch.algorithms.one_pass import lanczos_standard
from two_pass_lanczos_tpu_torch.algorithms.reorth import (
    make_pass_one_step_reorth,
    pass_one_scan_reorth,
    pass_one_scan_selective,
)
from two_pass_lanczos_tpu_torch.algorithms.two_pass import (
    lanczos_pass_one,
    lanczos_pass_two,
    lanczos_pass_two_with_basis,
)

__all__ = [
    "LanczosDecomposition",
    "breakdown_tolerance",
    "lanczos_recurrence_step",
    "lanczos_standard",
    "lanczos_standard_chunked",
    "lanczos_pass_one",
    "lanczos_pass_one_chunked",
    "lanczos_pass_two",
    "lanczos_pass_two_with_basis",
    # reorthogonalised one-pass Lanczos
    "pass_one_scan_reorth",
    "make_pass_one_step_reorth",
    "pass_one_scan_selective",
    # block Lanczos
    "BlockDecomposition",
    "block_pass_one",
    "block_pass_two",
    "block_padded_f_e1",
    "solve_fAb_block",
    "solve_fAb_block_jit",
]
