"""SE(2) geometry helpers, elementwise over any shape (port of
``tpu_pathopt.geometry``; reference: src/tools/tools.cpp)."""

from __future__ import annotations

import math

import torch


def constrain_angle(angle):
    """Wrap angle to [-pi, pi). ``torch.remainder`` takes the sign of the
    divisor, as ``jnp.mod`` does, and matches it bit for bit in float32."""
    return torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi


def distance(x1, y1, x2, y2):
    return torch.hypot(x2 - x1, y2 - y1)


def local_to_global(ref_x, ref_y, ref_heading, x, y, heading=0.0):
    """Frame (ref_x, ref_y, ref_heading) to global (reference: tools.cpp:50-55)."""
    c, s = torch.cos(ref_heading), torch.sin(ref_heading)
    gx = x * c - y * s + ref_x
    gy = x * s + y * c + ref_y
    return gx, gy, ref_heading + heading


def global_to_local(ref_x, ref_y, ref_heading, x, y, heading=0.0):
    """Inverse of :func:`local_to_global` (reference: tools.cpp:57-64)."""
    dx, dy = x - ref_x, y - ref_y
    c, s = torch.cos(ref_heading), torch.sin(ref_heading)
    lx = dx * c + dy * s
    ly = -dx * s + dy * c
    return lx, ly, heading - ref_heading


def normal_offset(x, y, heading, l):
    """Point displaced laterally by l along the left normal of `heading`."""
    return x - l * torch.sin(heading), y + l * torch.cos(heading)
