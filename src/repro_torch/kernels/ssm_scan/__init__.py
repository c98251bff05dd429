from repro_torch.kernels.ssm_scan.ops import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_ref"]
