r"""
Pytrees of tensors: nested tuples, lists, dicts and ``NamedTuple``\ s with
tensors (or any other object) at the leaves.

The MCMC layer (:mod:`rodeo_tpu_torch.inference.pseudo_marginal`,
:mod:`rodeo_tpu_torch.parallel`) carries chain positions and states as
pytrees, as the JAX package does with ``jax.tree_util``.  The leaves come
in the JAX package's order: a tuple's, list's or ``NamedTuple``'s in
their order, a dict's by sorted key, and ``None`` is a node without
leaves; so a state flattened here and there lists the same leaves, and a
checkpoint written by one package loads in the other.
"""
import torch

__all__ = ["tree_flatten", "tree_unflatten", "tree_leaves", "tree_map",
           "tree_structure", "ravel"]


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten(tree):
    """The leaves of ``tree`` in order, and its structure (a value that
    compares equal for trees of the same shape)."""
    leaves = []

    def walk(node):
        if node is None:
            return ("none",)
        if _is_namedtuple(node):
            return ("namedtuple", type(node), tuple(walk(c) for c in node))
        if isinstance(node, (tuple, list)):
            return ("tuple" if isinstance(node, tuple) else "list",
                    tuple(walk(c) for c in node))
        if isinstance(node, dict):
            keys = tuple(sorted(node))
            return ("dict", keys, tuple(walk(node[k]) for k in keys))
        leaves.append(node)
        return ("leaf",)

    spec = walk(tree)
    return leaves, spec


def tree_unflatten(spec, leaves):
    """The tree of structure ``spec`` (from :func:`tree_flatten`) with
    ``leaves`` in order."""
    leaves = list(leaves)
    it = iter(leaves)

    def build(s):
        kind = s[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "namedtuple":
            return s[1](*(build(c) for c in s[2]))
        if kind == "dict":
            return {k: build(c) for k, c in zip(s[1], s[2])}
        children = [build(c) for c in s[1]]
        return tuple(children) if kind == "tuple" else children

    n_leaves = sum(1 for _ in _spec_leaves(spec))
    if n_leaves != len(leaves):
        raise ValueError(f"the structure holds {n_leaves} leaves, got "
                         f"{len(leaves)}")
    return build(spec)


def _spec_leaves(s):
    if s[0] == "leaf":
        yield s
    elif s[0] != "none":
        for c in s[-1]:
            yield from _spec_leaves(c)


def tree_leaves(tree):
    """The leaves of ``tree`` in order."""
    return tree_flatten(tree)[0]


def tree_structure(tree):
    """The structure of ``tree``, as :func:`tree_flatten` gives it."""
    return tree_flatten(tree)[1]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees ``rest`` of the
    same structure."""
    leaves, spec = tree_flatten(tree)
    others = []
    for other in rest:
        o_leaves, o_spec = tree_flatten(other)
        if o_spec != spec:
            raise ValueError("tree_map takes trees of one structure")
        others.append(o_leaves)
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])


def ravel(tree):
    """The leaves of a tree of tensors flattened into one 1-D tensor (the
    counterpart of ``jax.flatten_util.ravel_pytree``) and the function that
    rebuilds the tree from such a tensor."""
    leaves, spec = tree_flatten(tree)
    leaves = [torch.as_tensor(x) for x in leaves]
    shapes = [x.shape for x in leaves]
    sizes = [x.numel() for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(vec):
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(vec[off:off + size].reshape(shape))
            off += size
        return tree_unflatten(spec, out)

    return flat, unravel
