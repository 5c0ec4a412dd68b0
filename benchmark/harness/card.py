"""The card's peaks and what it reports of itself.

HBM bandwidth is the H100 SXM data sheet's 3.35 TB/s. The 32-bit integer
rate is worked out from the card as `chip_smoke.int32_rate` does: 128
operations a clock an SM (both integer pipes, 64 a clock each) times the
SM count times the maximum SM clock nvidia-smi reports. Both assume the
card's full power limit, which is read beside them.
"""

from __future__ import annotations

import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 128


def _smi(field: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def describe() -> dict:
    """Name, power limit, maximum SM clock, SM count and the int32 rate of
    card 0."""
    mhz = float(_smi("clocks.max.sm"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        power = float(_smi("power.limit"))
    except (ValueError, subprocess.CalledProcessError):
        power = None
    return {"name": torch.cuda.get_device_name(0), "power_limit_w": power,
            "max_sm_mhz": mhz, "sms": sms,
            "int32_ops_per_s": INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6,
            "hbm_bytes_per_s": HBM_BYTES_PER_S}


def least_seconds(nbytes: float, ops: float, card: dict) -> float:
    """The least time the card could take: the larger of the bytes at its
    bandwidth and the operations at its integer rate."""
    return max(nbytes / card["hbm_bytes_per_s"],
               ops / card["int32_ops_per_s"])
