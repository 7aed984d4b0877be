"""The least work of the DP corridor search's edges: every edge cost
between two adjacent layers of the lattice and the forward pass over them
(the edge tables and K4 together), from the lattice's shape alone: B
scenarios, ``layers`` layers of edges (L - 1) and K laterals a layer. The
count is the reference's (``reference/pipeline.py``, ``search_corridor``),
whatever implements it.

Bytes: what the edges are made from, read once (each node's x and y on
all L layers; each edge layer's heading, the node's self cost and its
feasibility (one byte); each layer's s; layer 0's cost and incoming
direction), and what the forward pass leaves, written once (each node's
cost and parent (int32), each layer's alive flag (one byte)). The edge
tables a program may materialise between the two are not counted: a
program that never writes them reads nearer its bound, not past it.

Float operations: :data:`EDGE_FLOPS` an edge: the two differences of the
node positions, the direction (atan2, counted as :data:`ATAN2_FLOPS`), the
angle change and the reference-angle term (each a difference, the wrap
into (-pi, pi] counted as 3, an absolute value, a division and a
product), the lateral reach test (a difference, an absolute value, a
comparison), the three additions of the total and the comparison of the
minimum."""

from __future__ import annotations

from h100_bench.metrics._work import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

ATAN2_FLOPS = 20    # a range reduction, a division and a polynomial
WRAP_FLOPS = 3
ANGLE_TERM_FLOPS = 1 + WRAP_FLOPS + 3
EDGE_FLOPS = 2 + ATAN2_FLOPS + 2 * ANGLE_TERM_FLOPS + 3 + 3 + 1


def work(b: int, layers: int, k: int) -> tuple[int, int]:
    """(bytes, float operations) of the edges of ``b`` lattices of
    ``layers`` edge layers and ``k`` laterals."""
    f = 4
    nodes = b * (layers + 1) * k
    ins = (2 * nodes * f                 # node x, y
           + b * layers * f              # each edge layer's heading
           + b * layers * k * (f + 1)    # self cost, feasibility
           + b * (layers + 1) * f        # each layer's s
           + 2 * b * k * f)              # layer 0's cost, direction
    outs = b * layers * k * 2 * f + b * layers
    return ins + outs, b * layers * k * k * EDGE_FLOPS


def bound_ms(b: int, layers: int, k: int) -> tuple[float, str]:
    """The least ms of that work on the card, and what bounds it."""
    nbytes, flops = work(b, layers, k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
