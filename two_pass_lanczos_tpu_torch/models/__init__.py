"""Problem families: KKT systems, synthetic spectra, generated instances."""

from two_pass_lanczos_tpu_torch.models.generator import generate_mcf_instance
from two_pass_lanczos_tpu_torch.models.kkt import (
    KKTSystem,
    kkt_operator_from_arrays,
    kkt_operator_from_files,
    kkt_sorted_coo,
)
from two_pass_lanczos_tpu_torch.models.synthetic import (
    SCENARIOS,
    create_diagonal_problem,
    dense_random_symmetric,
    hofstadter_triplets,
)

__all__ = [
    "create_diagonal_problem",
    "dense_random_symmetric",
    "SCENARIOS",
    "hofstadter_triplets",
    "KKTSystem",
    "kkt_operator_from_arrays",
    "kkt_operator_from_files",
    "kkt_sorted_coo",
    "generate_mcf_instance",
]
