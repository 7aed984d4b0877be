"""Build the port's dataclasses from the JAX package's, given as dicts of
numpy arrays (field name -> array, batch-leading where the JAX value is
batched).

This lets a test feed each stage of the port exactly the inputs the JAX
stage saw, so a difference in an early stage (the EDT, a spline) cannot
mask one in a later stage (a QP). Integer arrays become int64 (the port's
index type), floats float32, booleans stay booleans; a dense QP and a
``QPSolution`` keep their own float precision (:func:`dense_qp`,
:func:`qp_solution`), so both packages' dense solvers see the same QP. The port never imports the
JAX package: the caller turns its dataclasses into dicts, e.g.
``{f.name: numpy.asarray(getattr(obj, f.name)) for f in fields(obj)}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_pathopt_torch import corridor as corridor_mod
from tpu_pathopt_torch import maps, pipeline, refpath
from tpu_pathopt_torch.qp import admm, structured
from tpu_pathopt_torch.solver import assembly
from tpu_pathopt_torch.torchutil import resolve_device


def tensor(a, device=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor of the port's type for it,
    copied."""
    a = np.array(a)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    else:
        dtype = torch.float32
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def _build(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d.get(f.name)
        kw[f.name] = None if v is None else tensor(v, device)
    return cls(**kw)


def grid_map(d: dict, device=None) -> maps.GridMap:
    """GridMap from esdf (padded), n_rows, n_cols and resolution."""
    esdf = tensor(d["esdf"], device)
    return maps.GridMap(esdf=esdf, quad=maps.pack_quad(esdf),
                        n_rows=int(d["n_rows"]), n_cols=int(d["n_cols"]),
                        resolution=float(d.get("resolution", 0.2)))


def scenario(d: dict, device=None) -> pipeline.Scenario:
    return _build(pipeline.Scenario, d, device)


def dp_lattice(d: dict, device=None) -> corridor_mod.DpLattice:
    return _build(corridor_mod.DpLattice, d, device)


def corridor(d: dict, device=None) -> corridor_mod.Corridor:
    return _build(corridor_mod.Corridor, d, device)


def ref_states(d: dict, device=None) -> refpath.RefStates:
    return _build(refpath.RefStates, d, device)


def corridor_bounds(d: dict, device=None) -> refpath.CorridorBounds:
    return _build(refpath.CorridorBounds, d, device)


def path_qp(d: dict, device=None) -> assembly.PathQP:
    return _build(assembly.PathQP, d, device)


def block_banded_qp(d: dict, device=None) -> structured.BlockBandedQP:
    return _build(structured.BlockBandedQP, d, device)


def qp_warm_start(d: dict, device=None) -> pipeline.QPWarmStart:
    return _build(pipeline.QPWarmStart, d, device)


def path_result(d: dict, device=None) -> pipeline.PathResult:
    """PathResult from its fields; ``d["bounds"]``, if given, is the dict
    of its CorridorBounds."""
    kw = {f.name: tensor(d[f.name], device)
          for f in dataclasses.fields(pipeline.PathResult)
          if f.name != "bounds"}
    b = d.get("bounds")
    return pipeline.PathResult(
        **kw, bounds=None if b is None else corridor_bounds(b, device))


def _exact(a, device=None) -> torch.Tensor:
    """A numpy array as a tensor of its own float precision (float64 stays
    float64), integers as int64, copied."""
    a = np.array(a)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=resolve_device(device))


def dense_qp(qp, device=None) -> tuple:
    """A dense QP ``(P, q, A, l, u)`` (either package's, or numpy) as
    tensors of its own precision, for ``qp.admm``'s solvers."""
    return tuple(_exact(a, device) for a in qp)


def qp_solution(d: dict, device=None) -> admm.QPSolution:
    """``admm.QPSolution`` from the fields of a JAX ``QPSolution``, each of
    its own precision (the port's ``rounds``, which the JAX solution does
    not carry, left at its default)."""
    return admm.QPSolution(**{f.name: _exact(d[f.name], device)
                              for f in dataclasses.fields(admm.QPSolution)
                              if f.name in d})
