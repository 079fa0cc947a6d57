"""Host-side utilities of the port."""

from daliid_tpu_torch.utils.profiling import PhaseTimer, phase, profile_to, trace_annotation

__all__ = ["PhaseTimer", "phase", "trace_annotation", "profile_to"]
