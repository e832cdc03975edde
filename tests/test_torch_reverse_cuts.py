"""
The reverse recursions K2r, K4, K6, K11e and K10b, through their wrappers
on the CPU (their plain twins), run over a path's last rows from the
path's own end seeds: their rows are the whole path's last rows, bitwise.
chip_smoke.py holds each kernel to its twin on such a cut of its path
(``rows_cut(..., from_end=True)``) and the cut's rows to the whole path's
(``as_on_path``), since the kernels compute the twins' arithmetic in the
twins' order.
"""
import numpy as np
import pytest
import torch

from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_magi as fm
from rodeo_tpu_torch.ops import fused_sim as fs

N_ROWS, N_CUT, N_BLOCK, N_LANE, Q = 37, 13, 2, 5, 3


def _normal(rng, *shape, scale=1.0):
    return torch.tensor(scale * rng.standard_normal(shape),
                        dtype=torch.float32)


def _cases(rng):
    """Each recursion's call on seeded operands: (its call, its operands,
    how many lead operands hold a row a step, how many outputs do, the
    rows the recursion adds after its own: K2r's terminal row)."""
    n_tri = Q * (Q + 1) // 2
    lanes = (N_BLOCK, N_LANE)
    t_vec = torch.tensor([1.0, 0.5, 0.25])
    k2r = (_normal(rng, N_ROWS, Q, *lanes),
           _normal(rng, N_ROWS, Q * Q, *lanes, scale=0.5),
           _normal(rng, N_ROWS, n_tri, *lanes), _normal(rng, Q, *lanes),
           _normal(rng, n_tri, *lanes), _normal(rng, Q, *lanes), t_vec,
           fk._tri_scale(t_vec))
    k4 = (_normal(rng, N_ROWS, N_BLOCK, Q),
          _normal(rng, N_ROWS, N_BLOCK, Q * Q, scale=0.5),
          _normal(rng, N_ROWS, N_BLOCK, n_tri), _normal(rng, N_BLOCK, Q),
          _normal(rng, N_BLOCK, n_tri))
    k6 = (_normal(rng, N_ROWS, Q, *lanes),
          _normal(rng, N_ROWS, Q * Q, *lanes, scale=0.5),
          _normal(rng, Q, *lanes))
    n_tan = 2
    k11e = (_normal(rng, N_ROWS, (1 + n_tan) * Q, *lanes),
            _normal(rng, N_ROWS, (1 + n_tan) * Q * Q, *lanes, scale=0.5),
            _normal(rng, (1 + n_tan) * Q, *lanes), n_tan)
    act = 2
    q_const = [[float(v) for v in row]
               for row in np.triu(0.5 * rng.standard_normal((Q, Q)))]
    k10b = (_normal(rng, N_ROWS, act, *lanes),
            _normal(rng, N_ROWS, act * (act + 1) // 2, *lanes),
            _normal(rng, N_ROWS, (Q - act) * act, *lanes), q_const)
    return {"K2r": (fk.smoother_recursion_batch_rows, k2r, 3, 2, 1),
            "K4": (fk.smoother_recursion, k4, 3, 2, 0),
            "K6": (fs.sampler_batch, k6, 2, 1, 0),
            "K11e": (fk.smoother_mean_recursion_batch_tan, k11e, 2, 1, 0),
            "K10b": (fm.magi_adjoint_batch, k10b, 3, 1, 0)}


@pytest.mark.parametrize("kernel", ["K2r", "K4", "K6", "K11e", "K10b"])
def test_reverse_recursion_from_the_end_gives_the_paths_last_rows(kernel):
    call, args, n_rows, n_out, extra = _cases(
        np.random.default_rng(11))[kernel]

    def outputs(*a):
        out = call(*a)
        return out if isinstance(out, tuple) else (out,)

    whole = outputs(*args)
    cut = outputs(*[a[-N_CUT:] if i < n_rows else a
                    for i, a in enumerate(args)])
    m = N_CUT + extra
    for k in range(n_out):
        assert whole[k].shape[0] == N_ROWS + cut[k].shape[0] - N_CUT
        assert torch.equal(cut[k][-m:], whole[k][-m:]), k
