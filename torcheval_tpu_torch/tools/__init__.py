"""Model-evaluation tools (the port of ``torcheval_tpu/tools``; upstream
``torcheval/tools``): module summaries and FLOP counting over
``torch.nn.Module`` trees with torch's ``FlopCounterMode``, profiler
entry points and per-metric lifecycle clocks, and the roofline
device-peak table.

Left out of the JAX package's exports, having no counterpart:
``normalize_cost_analysis`` and ``memory_stats_of`` (they read XLA's
compiled objects; see ``tools/flops.py``)."""

from torcheval_tpu_torch.tools import profiling, roofline
from torcheval_tpu_torch.tools.flops import (
    cost_summary,
    flops_of,
    forward_backward_flops,
    peak_memory_of,
)
from torcheval_tpu_torch.tools.module_summary import (
    get_module_summary,
    get_params_summary,
    get_summary_table,
    ModuleSummary,
    prune_module_summary,
)
from torcheval_tpu_torch.tools.profiling import ProfiledMetric, profile_summary_table
from torcheval_tpu_torch.tools.roofline import (
    device_peaks,
    register_device_peaks,
    reread_multiplier,
)

__all__ = [
    "cost_summary",
    "device_peaks",
    "flops_of",
    "forward_backward_flops",
    "get_module_summary",
    "get_params_summary",
    "get_summary_table",
    "ModuleSummary",
    "peak_memory_of",
    "ProfiledMetric",
    "profile_summary_table",
    "profiling",
    "prune_module_summary",
    "register_device_peaks",
    "reread_multiplier",
    "roofline",
]
