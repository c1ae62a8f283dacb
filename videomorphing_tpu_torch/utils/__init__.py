"""Host utilities of the port: metrics logging, profiling phases, the field
store and the synthetic clips of the benchmarks."""

from videomorphing_tpu_torch.utils.logging import MetricsLogger, level_record
from videomorphing_tpu_torch.utils.profiling import phase_scope, trace_to
from videomorphing_tpu_torch.utils.checkpoint import FieldStore

# Names of the reference's __all__ that serve only XLA (its compile cache):
# not ported.
NOT_PORTED = ("enable_compile_cache",)

__all__ = [
    "MetricsLogger",
    "level_record",
    "phase_scope",
    "trace_to",
    "FieldStore",
]
