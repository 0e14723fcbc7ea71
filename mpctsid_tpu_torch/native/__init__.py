from mpctsid_tpu_torch.native.runtime import (PlanBuffer, RtExecutor,
                                              TelemetryRing, ensure_built)

__all__ = ["PlanBuffer", "RtExecutor", "TelemetryRing", "ensure_built"]
