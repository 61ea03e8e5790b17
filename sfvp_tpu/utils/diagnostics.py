"""Device capability checks — the analog of the reference's instance /
device-extension negotiation and support report (ref main.cpp:150, 193-212):
instead of enumerating VK_KHR_* extensions, report device kind, device
count and memory budget, and fail early with a readable message when
requirements are unmet.
"""

from __future__ import annotations

from typing import List, Optional

import jax


def device_report() -> List[dict]:
    out = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "device_kind": getattr(d, "device_kind", "?"),
        }
        stats = d.memory_stats() or {}
        lim = stats.get("bytes_limit")
        use = stats.get("bytes_in_use")
        if lim is not None:
            info["mem_limit_gb"] = round(lim / 2**30, 2)
        if use is not None:
            info["mem_in_use_gb"] = round(use / 2**30, 3)
        out.append(info)
    return out


def check_capabilities(
    min_devices: int = 1, platform: Optional[str] = None
) -> List[dict]:
    """Raises RuntimeError with a readable report when requirements are
    unmet (the analog of the reference's 'unsupported extensions' throw,
    ref main.cpp:203-211). ``platform`` (e.g. "gpu") requires jax's
    default backend to be that platform: a measurement that needs the
    card must not fall back to the CPU."""
    report = device_report()
    problems = []
    if len(report) < min_devices:
        problems.append(f"need >= {min_devices} devices, have {len(report)}")
    if platform is not None and jax.default_backend() != platform:
        problems.append(
            f"platform {platform!r} required but jax's backend is "
            f"{jax.default_backend()!r}"
        )
    if problems:
        raise RuntimeError(
            "capability check failed: "
            + "; ".join(problems)
            + f" — device report: {report}"
        )
    return report


def print_report() -> None:
    for r in device_report():
        print(r)
