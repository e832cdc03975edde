"""
The draws of the JAX package's MCMC runners, rebuilt from their key trees
with jax.random, as the numpy arrays that the port's runners take as
``noise=``.  Each function follows the split order of one runner in
rodeo_tpu/parallel/chains.py or nuts.py (cited beside it), so that the
port, fed these arrays, runs the JAX runner's chain; then the checks that
hold a replayed chain to the JAX package's, lane by lane, allowing a
decision to differ only at a tie that float32 rounding may decide either
way.
"""
import numpy as np
import jax
import jax.numpy as jnp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _split(key, n):
    return jax.random.split(key, n)


def _leaf_normals(key, leaves):
    """One normal draw per leaf from the split of ``key`` over the leaves
    (chains.py:267-273, :360-366)."""
    keys = jax.random.split(key, len(leaves))
    return [jax.random.normal(k, np.shape(leaf), jnp.float32)
            for k, leaf in zip(keys, leaves)]


def mala_or_hmc(key, n_samples, position, n_lane, part):
    """make_mala_runner (chains.py:265-273, :280, :294) and
    make_hmc_runner (:358-366, :382, :397): per step ``k_prop`` (or
    ``k_mom``) and ``k_acc``; the normals of each leaf of ``position``
    under ``part`` ("xi" or "mom"), stacked over the steps in the
    position's structure, and the uniforms under "u"."""
    leaves, treedef = jax.tree.flatten(position)
    normals, uniforms = [], []
    for step_key in _split(key, n_samples):
        k_draw, k_acc = _split(step_key, 2)
        normals.append(_leaf_normals(k_draw, leaves))
        uniforms.append(jax.random.uniform(k_acc, (n_lane,), jnp.float32))
    stacked = [np.stack([np.asarray(n[i]) for n in normals])
               for i in range(len(leaves))]
    return {part: jax.tree.unflatten(treedef, stacked),
            "u": np.stack(_np(uniforms))}


def _path_normals(key, n_steps, q, n_block, n_lane):
    """solve_sim_fused_batch's normals from its key (pallas_sim.py:174-181,
    kramer and rodeo)."""
    key_path, key_term = _split(key, 2)
    return (np.array(jax.random.normal(
        key_path, (n_steps - 1, q, n_block, n_lane), jnp.float32)),
        np.array(jax.random.normal(key_term, (q, n_block, n_lane),
                                     jnp.float32)))


def _interrogation_normals(key, n_steps, q, n_block, n_lane):
    """Under chkrebtii, solve_sim_fused_batch first splits its key into
    ``(key, key_int)`` and draws the interrogations' normals from
    ``key_int`` (pallas_sim.py:154-158); returns the key left and them."""
    key, key_int = _split(key, 2)
    return key, np.array(jax.random.normal(
        key_int, (n_steps, q, n_block, n_lane), jnp.float32))


def chain_runner(key, n_samples, n_lane, n_theta, n_steps, q, n_block,
                 interrogation="kramer"):
    """make_chain_runner (chains.py:189-194, :202-204): ``key_init`` for the
    initial estimate, then per step ``k_prop, k_path, k_acc``; under
    chkrebtii each estimate's key gives the interrogations' normals too
    ("init_eps_int", "eps_int")."""
    chkrebtii = interrogation == "chkrebtii"
    key_init, key_scan = _split(key, 2)
    noise = {}
    if chkrebtii:
        key_init, noise["init_eps_int"] = _interrogation_normals(
            key_init, n_steps, q, n_block, n_lane)
    init_eps, init_eps_term = _path_normals(key_init, n_steps, q, n_block,
                                            n_lane)
    out = {k: [] for k in ("prop", "eps", "eps_term", "u")
           + ("eps_int",) * chkrebtii}
    for step_key in _split(key_scan, n_samples):
        k_prop, k_path, k_acc = _split(step_key, 3)
        out["prop"].append(np.array(jax.random.normal(
            k_prop, (n_lane, n_theta), jnp.float32)))
        if chkrebtii:
            k_path, eps_int = _interrogation_normals(k_path, n_steps, q,
                                                     n_block, n_lane)
            out["eps_int"].append(eps_int)
        eps, eps_term = _path_normals(k_path, n_steps, q, n_block, n_lane)
        out["eps"].append(eps)
        out["eps_term"].append(eps_term)
        out["u"].append(np.array(jax.random.uniform(
            k_acc, (n_lane,), jnp.float32)))
    noise.update({k: np.stack(v) for k, v in out.items()})
    noise.update(init_eps=init_eps, init_eps_term=init_eps_term)
    return noise


def gibbs(key, n_sweeps, n_inner, shape_u, n_lane, gamma_shape):
    """run_chains_magi_gibbs (chains.py:804-808, :824-837): per sweep
    ``k_inner`` (split over the inner MALA steps, each ``k_prop, k_acc``)
    and ``k_gibbs``, a gamma variate of shape ``gamma_shape`` per lane."""
    out = {"xi": [], "u": [], "gamma": []}
    for sweep_key in _split(key, n_sweeps):
        k_inner, k_gibbs = _split(sweep_key, 2)
        xi, u = [], []
        for step_key in _split(k_inner, n_inner):
            k_prop, k_acc = _split(step_key, 2)
            xi.append(np.array(jax.random.normal(k_prop, shape_u,
                                                   jnp.float32)))
            u.append(np.array(jax.random.uniform(k_acc, (n_lane,),
                                                   jnp.float32)))
        out["xi"].append(np.stack(xi))
        out["u"].append(np.stack(u))
        out["gamma"].append(np.array(jax.random.gamma(
            k_gibbs, gamma_shape, (n_lane,), jnp.float32)))
    return {k: np.stack(v) for k, v in out.items()}


def nuts(key, n_samples, n_lane, dim, max_depth):
    """make_nuts_runner (nuts.py:123-124, :283-284, :149, :192, :256,
    :303): per proposal ``k_mom`` and ``k_loop``; per doubling j the split
    of the carried key into ``k_dir, k_merge, k_leaves``, and ``k_leaves``
    split over the doubling's ``2**j`` leaves."""
    out = {k: [] for k in ("mom", "forward", "u_merge", "u_leaf")}
    for step_key in _split(key, n_samples):
        k_mom, k_loop = _split(step_key, 2)
        out["mom"].append(np.array(jax.random.normal(
            k_mom, (n_lane, dim), jnp.float32)))
        fwd, merge, leaves = [], [], []
        k = k_loop
        for j in range(max_depth):
            k, k_dir, k_merge, k_leaves = _split(k, 4)
            fwd.append(np.array(jax.random.bernoulli(k_dir,
                                                       shape=(n_lane,))))
            merge.append(np.array(jax.random.uniform(
                k_merge, (n_lane,), jnp.float32)))
            leaves += [np.array(jax.random.uniform(kn, (n_lane,),
                                                     jnp.float32))
                       for kn in _split(k_leaves, 1 << j)]
        out["forward"].append(np.stack(fwd))
        out["u_merge"].append(np.stack(merge))
        out["u_leaf"].append(np.stack(leaves))
    return {k: np.stack(v) for k, v in out.items()}


def run_chains(key, n_samples, n_chains, step_noise):
    """make_run_chains (chains.py:90-96, :77-85): ``split(key, n_chains +
    1)`` gives the scan's key and each chain's init key; each step's key is
    split over the chains.  ``step_noise(key_c)`` gives a chain step's
    noise from its key; returns the init keys and the stacked noise."""
    init_keys = _split(key, n_chains + 1)
    scan_key, chain_keys = init_keys[0], init_keys[1:]
    steps = [[step_noise(kc) for kc in _split(step_key, n_chains)]
             for step_key in _split(scan_key, n_samples)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs),
                           *[jax.tree.map(lambda *ys: np.stack(ys), *row)
                             for row in steps])
    return chain_keys, stacked


def rmh_step(key, flat_shape, dtype, ld_noise):
    """rmh_proposal's three-way split (pseudo_marginal.py:202, :102, :137):
    the proposal's normals, the acceptance's uniform (a scalar of
    ``dtype``, bernoulli's) and ``ld_noise(key_logdensity)``."""
    k_prop, k_acc, k_ld = _split(key, 3)
    return {"proposal": np.array(jax.random.normal(k_prop, flat_shape,
                                                     dtype)),
            "accept": np.array(jax.random.uniform(k_acc, (), dtype)),
            "logdensity": ld_noise(k_ld)}


# --- comparing a replayed chain with the JAX package's ----------------------

MARGIN = 1e-4


def moved(positions, init):
    """Each step's accept decision of each lane, from a chain's positions
    (a pytree of arrays with leading axes (steps, lanes)) and its start:
    whether any leaf moved."""
    flags = None
    for pos, x0 in zip(jax.tree.leaves(positions), jax.tree.leaves(init)):
        pos, x0 = np.asarray(pos), np.asarray(x0)
        prev = np.concatenate([x0[None], pos[:-1]])
        f = np.any((pos != prev).reshape(pos.shape[:2] + (-1,)), axis=-1)
        flags = f if flags is None else flags | f
    return flags


def steps_to_compare(dec_port, dec_jax, margin_at, margin=MARGIN):
    """How many leading steps of each lane's chain (the lanes are
    independent chains) must agree with the JAX package's: all, where every
    accept decision of the lane is the same; else up to the lane's first
    step ``s`` whose decision differs, after checking that
    ``margin_at(s, lane)``, the distance of the port's log acceptance ratio
    from its ``log(u)`` there, is below ``margin``: a tie that the two
    packages' float32 rounding may decide either way.  Returns the count
    per lane and prints each tie."""
    dec_port, dec_jax = np.asarray(dec_port), np.asarray(dec_jax)
    n_steps, n_lane = dec_port.shape
    counts = np.full(n_lane, n_steps)
    for s, lane in np.argwhere(dec_port != dec_jax):
        if counts[lane] < n_steps:
            continue
        gap = float(margin_at(int(s), int(lane)))
        assert gap < margin, (
            f"step {s}, lane {lane}: the decisions differ {gap} from the "
            f"threshold")
        print(f"step {s}, lane {lane}: a tie {gap} from the threshold; "
              f"the lane is compared up to step {s}")
        counts[lane] = s
    return counts


def assert_positions_close(port, ref, counts, tol):
    """Each lane's positions (pytrees of arrays with leading axes (steps,
    lanes)) over its first ``counts[lane]`` steps, within ``tol`` relative
    and absolute; returns the mask of the lanes compared in full."""
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        for lane, n in enumerate(counts):
            np.testing.assert_allclose(a[:n, lane], b[:n, lane], rtol=tol,
                                       atol=tol)
    return np.asarray(counts) == len(jax.tree.leaves(port)[0])
