"""Convert the JAX package's state, given as numpy arrays, into the port's.

The parity tests use these so both packages run on identical tables. Every
function takes plain objects whose fields are array-like (a JAX
BandedOperator, GraphOperator or PrecondState works as it is, through
np.asarray); nothing here imports JAX.
"""

import numpy as np
import torch

from mac_tpu_torch.ops import laplacian
from mac_tpu_torch.ops.banded import (
    STATICS,
    TABLES,
    BandedOperator,
    PrecondState,
)


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def banded_operator(src, device=None) -> BandedOperator:
    """BandedOperator from the nine tables and the static fields of `src`
    (an object with those attributes, or the dict `banded_tables` gives)."""
    tables = {name: np.asarray(_field(src, name)) for name in TABLES}
    statics = {name: int(_field(src, name)) for name in STATICS}
    bop = BandedOperator(tables, **statics)
    return bop if device is None else bop.to(device)


def banded_tables(bop) -> dict:
    """The nine tables (numpy int32) and the static fields of a banded
    operator, as a dict that `banded_operator` takes back."""
    out = {}
    for name in TABLES:
        v = _field(bop, name)
        out[name] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                     else np.asarray(v))
    out.update({name: int(_field(bop, name)) for name in STATICS})
    return out


def precond_state(src, dtype=torch.float32, device=None) -> PrecondState:
    """PrecondState from an object with Lc_inv, chain_dp and chain_l (the
    chain fields may be None)."""
    def conv(name):
        v = getattr(src, name)
        if v is None:
            return None
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    return PrecondState(Lc_inv=conv("Lc_inv"), chain_dp=conv("chain_dp"),
                        chain_l=conv("chain_l"))


def graph_operator(src, device=None) -> laplacian.GraphOperator:
    """GraphOperator from an object with the JAX GraphOperator's six tables
    (idx, nbr_tbl, eid_tbl, chain_slot, chain_mask, coarse_idx) and its
    static fields n, mode, coarse_s and coarse_nc; index tables become
    int64."""
    tables = {}
    for name in laplacian.TABLES:
        v = np.asarray(_field(src, name))
        tables[name] = torch.from_numpy(
            np.array(v, dtype=np.bool_ if v.dtype == np.bool_ else np.int64))
    op = laplacian.GraphOperator(
        **tables, n=int(_field(src, "n")), mode=str(_field(src, "mode")),
        coarse_s=int(_field(src, "coarse_s")),
        coarse_nc=int(_field(src, "coarse_nc")))
    return op if device is None else op.to(device)


def mac_params(params, dtype=torch.float32, device=None):
    """The port's MAC parameter tuple (w_fixed, w_cand, cand_idx, operator)
    from the JAX tuple (op, w_fixed, w_cand, chain_w, banded): cand_idx
    holds the candidates' internal endpoints, op.idx[m_fixed:] (RCM-
    relabelled on the banded route); the operator is the banded one when
    `banded` is given, else op itself (the matrix-free route, whose
    chain_w the port does not carry)."""
    op, w_fixed, w_cand, _chain_w, banded = params
    w_fixed = np.asarray(w_fixed)
    cand_idx = np.asarray(op.idx)[w_fixed.shape[0]:]
    operator = (graph_operator(op, device=device) if banded is None
                else banded_operator(banded, device=device))
    return (torch.tensor(w_fixed, dtype=dtype, device=device),
            torch.tensor(np.asarray(w_cand), dtype=dtype, device=device),
            torch.as_tensor(cand_idx.astype(np.int64), device=device),
            operator)
