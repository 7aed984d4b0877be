"""The card's state, read by ``nvidia-smi``: name, power limit, SM clock,
power draw and temperature."""

from __future__ import annotations

import subprocess

FIELDS = "name,power.limit,clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def state() -> str:
    """One CSV line per card, or the reason it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={FIELDS}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip() or out.stderr.strip()
