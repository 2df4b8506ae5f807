"""Utilities: data loading."""

from two_pass_lanczos_tpu_torch.utils.data_loader import (
    DataLoaderError,
    KKTArrays,
    load_kkt_arrays,
    parse_dmx,
    parse_qfc,
)

__all__ = ["DataLoaderError", "KKTArrays", "parse_dmx", "parse_qfc",
           "load_kkt_arrays"]
