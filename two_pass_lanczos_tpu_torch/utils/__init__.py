"""Utilities: data loading, performance measurement."""

from two_pass_lanczos_tpu_torch.utils.data_loader import (
    DataLoaderError,
    KKTArrays,
    load_kkt_arrays,
    parse_dmx,
    parse_qfc,
)
from two_pass_lanczos_tpu_torch.utils.perf import (
    Timer,
    device_memory_stats,
    get_peak_rss_kb,
)

__all__ = ["DataLoaderError", "KKTArrays", "parse_dmx", "parse_qfc",
           "load_kkt_arrays", "get_peak_rss_kb", "device_memory_stats",
           "Timer"]
