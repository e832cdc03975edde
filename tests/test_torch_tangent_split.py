"""
The filter twins of DALTON and fenrir's backward twins skip the
observation update at steps without data, and the launch of the split
kernels K1, K3, K5b, K8, K9, K11a, K11c and K11d, and of the streams K6,
K2r, K4, K7b, K11b, K7a, K10a and K10b, is the card's.

Kernels K8 (``csrc/dalton_filter_batch.cu``) and K11c
(``csrc/dalton_filter_batch_tan.cu``) skip the masked observation update,
and its log-density term, where the step's mask is 0, and so do their plain
twins ``_dalton_filter_plain`` and ``_dalton_filter_tan_plain`` by default;
K7b (``csrc/fenrir_backward_batch.cu``), K11b
(``csrc/fenrir_backward_batch_tan.cu``) and K7a
(``csrc/fenrir_backward_single.cu``) and their twins
``_fenrir_backward_plain`` (with ``skip_unobserved``, which K7b's wrapper
passes), ``_fenrir_backward_tan_plain`` and ``_fenrir_backward_single_plain``
do the same in fenrir's backward filter.  At such a step the update is
an exact identity (the gain is 0 and the term enters as 0 x a finite
number), so skipping it must change no bit: the tests hold each twin with
the skip to the same twin running the full update, bitwise, on Lorenz63
EK1 and FitzHugh-Nagumo EK0 with data (and fenrir's also on a grid without
any), the values, the log-density and every tangent direction.  Sizes: 300
steps x 3 lanes (one solve for K7a), 11 observations (every 30th step),
float32 on the CPU.  The launch geometry of K1, K3, K5b, K8, K9, K11a,
K11c, K11d, K6, K2r, K4, K7b, K11b, K7a, K10a and K10b comes from the card
alone (the card tests check it); here its queries must raise.
"""
import numpy as np
import pytest
import torch

from rodeo_tpu_torch.models import fitzhugh, lorenz
from rodeo_tpu_torch.models import obs as obs_models
from rodeo_tpu_torch.ops import fused_dalton as fd
from rodeo_tpu_torch.ops import fused_daltonng as fdn
from rodeo_tpu_torch.ops import fused_fenrir as ff
from rodeo_tpu_torch.ops import fused_kalman as fk
from rodeo_tpu_torch.ops import fused_magi as fm
from rodeo_tpu_torch.ops import fused_sim as fs

N_STEPS, N_LANE, N_OBS = 300, 3, 11
# (model module, interrogation, t_max)
CASES = {"lorenz": (lorenz, "kramer", 3.0),
         "fitzhugh": (fitzhugh, "rodeo", 15.0)}


def _call(model):
    """The DALTON entry points' arguments for a seeded lane batch of
    ``model`` with data, on the CPU: the observation model of the
    likelihood tests (the 0th derivative of every variable, variance
    0.005), data rng(0).normal x 5, thetas perturbed by 1 % per lane."""
    mod, mode, t_max = CASES[model]
    cfg = mod.setup(n_steps=N_STEPS, t_max=t_max, dtype=torch.float32,
                    device="cpu")
    rng = np.random.default_rng(0)
    thetas = cfg["theta"] * (1 + 0.01 * torch.tensor(
        rng.standard_normal((N_LANE, 3)), dtype=torch.float32))
    nb = mod.N_VARS
    weight = torch.zeros((N_OBS, nb, 1, 3))
    weight[..., 0] = 1.0
    return dict(
        thetas=thetas, ode_weight=cfg["ode_weight"],
        ode_inits=cfg["ode_init"].expand((N_LANE,) + cfg["ode_init"].shape),
        t_min=0.0, t_max=t_max, n_steps=N_STEPS,
        prior_pars=cfg["prior_pars"],
        obs_data=torch.tensor(rng.normal(size=(N_OBS, nb, 1)) * 5,
                              dtype=torch.float32),
        obs_times=torch.tensor(np.linspace(0.0, t_max, N_OBS),
                               dtype=torch.float32),
        obs_weight=weight, obs_var=torch.full((N_OBS, nb, 1, 1), 0.005),
        model=model, interrogation=mode, device="cpu")


def _operands(model):
    """K8's keyword operands for :func:`_call`'s batch (the seed ``ld0``
    left out), the resolved model and the seed."""
    c = _call(model)
    ops, grid, ld0 = fd._dalton_prepare(
        c["thetas"], c["ode_weight"], c["ode_inits"], 0.0, c["t_max"],
        N_STEPS, c["prior_pars"], c["obs_data"], c["obs_times"],
        c["obs_weight"], c["obs_var"])
    return (fk.resolve_model(model),
            dict(**ops, **grid, mode=c["interrogation"]), ld0)


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_dalton_twin_skip_is_the_full_update(model, with_obs):
    """K8's twin: the log-density with the skip equals the full update's
    bitwise."""
    fused, ops, ld0 = _operands(model)
    n_data = int((ops["mask"] != 0).sum())
    assert 0 < n_data < N_STEPS                     # steps of both kinds
    args = dict(**ops, ld0=ld0, with_obs=with_obs)
    skip = fd._dalton_filter_plain(fused, N_STEPS, **args)
    full = fd._dalton_filter_plain(fused, N_STEPS, **args,
                                   skip_unobserved=False)
    assert torch.isfinite(skip).all()
    assert torch.equal(skip, full)


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_dalton_tan_twin_skip_is_the_full_update(model, with_obs):
    """K11c's twin: the values and each tangent direction with the skip
    equal the full update's bitwise, and the values equal K8's twin's; the
    seed's tangents are nonzero."""
    fused, ops, ld0 = _operands(model)
    tangents = torch.tensor(np.random.default_rng(1).standard_normal(
        (3, N_LANE)), dtype=torch.float32)
    args = dict(**ops, ld0=torch.cat([ld0[None], tangents]),
                with_obs=with_obs)
    skip = fd._dalton_filter_tan_plain(fused, N_STEPS, **args)
    full = fd._dalton_filter_tan_plain(fused, N_STEPS, **args,
                                       skip_unobserved=False)
    assert skip.shape == (4, N_LANE) and torch.isfinite(skip).all()
    assert all(torch.equal(skip[a], full[a]) for a in range(4))
    value = fd._dalton_filter_plain(fused, N_STEPS, **ops, ld0=ld0,
                                    with_obs=with_obs, skip_unobserved=False)
    assert torch.equal(skip[0], value)
    # the tangents carry the data: they differ from the seed's
    assert not torch.equal(skip[1:], tangents)


def test_dalton_entry_points_take_the_skip():
    """The CPU wrappers take the skipping twins: the value and gradient
    entry points give the full update's log-likelihood bitwise."""
    fused, ops, ld0 = _operands("lorenz")
    full = (fd._dalton_filter_plain(fused, N_STEPS, **ops, ld0=ld0,
                                    with_obs=True, skip_unobserved=False)
            - fd._dalton_filter_plain(fused, N_STEPS, **ops,
                                      ld0=torch.zeros_like(ld0),
                                      with_obs=False, skip_unobserved=False))
    assert torch.equal(fd.dalton_fused_batch(**_call("lorenz")), full)
    ll, grad = fd.dalton_fused_batch_grad(**_call("lorenz"))
    assert torch.equal(ll, full)
    assert grad.shape == (N_LANE, 3) and torch.isfinite(grad).all()


def _fenrir_chains(model, with_obs):
    """The operands of K11b and of K7b (the seed ``ld0`` last) for
    :func:`_call`'s batch; without data, on a grid with none (d = 0, y =
    0, om = 1, mask = 0)."""
    c = _call(model)
    ops = fk._kernel_operands(c["thetas"], c["ode_weight"], c["ode_inits"],
                              0.0, c["t_max"], N_STEPS, c["prior_pars"])
    obs = [c[k] for k in ("obs_data", "obs_times", "obs_weight", "obs_var")]
    chains = [ff._fenrir_operands(fk.resolve_model(model), N_STEPS, 0.0,
                                  c["t_max"], ops, *obs, c["interrogation"],
                                  tangent=tangent) for tangent in (True, False)]
    if not with_obs:
        chains = [(*ch[:3], torch.zeros_like(ch[3]), torch.zeros_like(ch[4]),
                   torch.ones_like(ch[5]), torch.zeros_like(ch[6]), *ch[7:])
                  for ch in chains]
    return chains


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_fenrir_tan_twin_skip_is_the_full_update(model, with_obs):
    """K11b's twin: the values and each tangent direction with the skip
    equal the full update's bitwise; the shared twin of K7b with the skip
    equals its full update, and K11b's values equal it.  Without data both
    sum nothing."""
    tan, val = _fenrir_chains(model, with_obs)
    n_data = int((tan[6] != 0).sum())
    assert 0 < n_data < N_STEPS if with_obs else n_data == 0
    skip = ff._fenrir_backward_tan_plain(*tan[:-1], 3)
    full = ff._fenrir_backward_tan_plain(*tan[:-1], 3, skip_unobserved=False)
    n_block = CASES[model][0].N_VARS
    assert skip.shape == (4, n_block, N_LANE)
    assert torch.isfinite(skip).all()
    assert all(torch.equal(skip[a], full[a]) for a in range(4))
    value = ff._fenrir_backward_plain(*val[:-1])
    assert torch.equal(ff._fenrir_backward_plain(*val[:-1],
                                                 skip_unobserved=True), value)
    assert torch.equal(skip[0], value)
    if with_obs:
        # the tangents are carried: some direction moves every block's sum
        assert (skip[1:] != 0).any(dim=0).all()
    else:
        assert not skip.any()       # no data, no log-density


def _fenrir_single_chain(model, with_obs):
    """K7a's operands (the seed ``ld0`` last) for one solve of ``model`` at
    :func:`_call`'s first theta, with its data; without data, on a grid with
    none (d = 0, y = 0, om = 1, mask = 0)."""
    c = _call(model)
    ops, Qs = fk._single_operands(c["thetas"][0], c["ode_weight"],
                                  c["ode_inits"][0], 0.0, c["t_max"],
                                  N_STEPS, c["prior_pars"])
    ops["q_const"] = ff._const_coefs(Qs)
    ch = ff._fenrir_single_operands(
        fk.resolve_model(model), N_STEPS, 0.0, c["t_max"], ops, Qs,
        *[c[k] for k in ("obs_data", "obs_times", "obs_weight", "obs_var")],
        c["interrogation"])
    if not with_obs:
        ch = (*ch[:3], torch.zeros_like(ch[3]), torch.zeros_like(ch[4]),
              torch.ones_like(ch[5]), torch.zeros_like(ch[6]), *ch[7:])
    return ch


@pytest.mark.parametrize("with_obs", [True, False])
@pytest.mark.parametrize("model", ["lorenz", "fitzhugh"])
def test_fenrir_single_twin_skip_is_the_full_update(model, with_obs):
    """K7a's twin: each block's log-density sum with the skip equals the
    full update's bitwise, on one solve's chain; the CPU wrapper takes the
    skip.  Without data both sum nothing."""
    ch = _fenrir_single_chain(model, with_obs)
    n_data = int((ch[6] != 0).sum())
    assert 0 < n_data < N_STEPS if with_obs else n_data == 0
    skip = ff._fenrir_backward_single_plain(*ch[:-1])
    full = ff._fenrir_backward_single_plain(*ch[:-1], skip_unobserved=False)
    assert skip.shape == (CASES[model][0].N_VARS,)
    assert torch.isfinite(skip).all()
    assert torch.equal(skip, full)
    ld = ff.fenrir_backward_single(*ch)
    assert torch.equal(ld, ch[-1] + fd._block_sum(full))
    if with_obs:
        assert skip.all()           # every block observes the data
    else:
        assert not skip.any()       # no data, no log-density


@pytest.mark.parametrize("query,takes_mode", [
    (lambda **kw: fk._filter_batch_geometry("lorenz", 37, **kw), True),
    (lambda **kw: fd._dalton_filter_batch_geometry("fitzhugh", 37, **kw),
     True),
    (lambda **kw: fk._filter_batch_tan_geometry("lorenz", 37, **kw), True),
    (lambda **kw: fd._dalton_filter_batch_tan_geometry("fitzhugh", 37, **kw),
     True),
    (lambda **kw: fdn._filter_nn_batch_tan_geometry(
        "fitzhugh", obs_models.poisson(0.1, 0.05), 37, **kw), True),
    (lambda **kw: fdn._filter_nn_batch_geometry(
        "lorenz", obs_models.gauss(0.005), 37, **kw), True),
    (lambda **kw: fs._sampler_batch_geometry(111, **kw), False),
    (lambda **kw: fk._filter_single_geometry("fitzhugh", **kw), True),
    (lambda **kw: fk._smoother_batch_rows_geometry(3, 37, **kw), False),
    (lambda **kw: fk._smoother_single_geometry(7, **kw), False),
    (lambda **kw: ff._fenrir_backward_batch_tan_geometry(3, 37, 3, **kw),
     False),
    (lambda **kw: ff._fenrir_backward_batch_geometry(3, 37, **kw), False),
    (lambda **kw: ff._fenrir_backward_single_geometry(7, **kw), False),
    (lambda **kw: fm._magi_batch_geometry(3, 37, 2, "adjoint", **kw),
     False),
    (lambda **kw: fm._magi_adjoint_batch_geometry(3, 37, 2, **kw), False),
    (lambda **kw: fk._mean_boundary_geometry("fitzhugh", **kw), False),
    (lambda **kw: fk._mean_gain_geometry("lorenz", **kw), False),
    (lambda **kw: fk._mean_recovery_geometry("lorenz", 155, **kw), False)],
    ids=["K1", "K8", "K11a", "K11c", "K11d", "K9", "K6", "K3", "K2r", "K4",
         "K11b", "K7b", "K7a", "K10a", "K10b", "K5b", "K5a", "K5c"])
def test_launch_geometry_is_the_cards(query, takes_mode):
    """The kernels' launch geometry comes from the card's report of the
    kernel: on the CPU the query raises, as it does for a mode the filters
    do not take, and nothing answers in the card's place."""
    with pytest.raises(NotImplementedError):
        query(device="cpu")
    if takes_mode:
        with pytest.raises(NotImplementedError):
            query(mode="bogus", device="cpu")
