r"""
Forward-mode numbers for the plain PyTorch twins of the tangent kernels
(the CUDA side is ``csrc/dual.cuh``), and the second-order number
:class:`Jet2` of the Laplace derivatives (``csrc/jet.cuh``).

A :class:`Dual` holds a value ``v`` and its tangents ``d`` along ``n_dir``
directions at once, ``d`` having one leading axis more than ``v``.  Its
rules are written once here and once in ``csrc/dual.cuh``, with their
operations in the same order, and the value part of every rule is exactly
the plain operation.  So the column functions of
:mod:`rodeo_tpu_torch.ops.fused_kalman` and the plain twins run on Duals
unchanged (operator overloads, ``__getitem__`` and ``__torch_function__``
for the few torch functions they call), their values equal the plain twins'
bitwise, and each tangent rounds as the kernel's thread of that direction
rounds.  A plain tensor or Python number mixed with a Dual is a constant:
its tangent is zero and is not materialised.

The rules (value ``a``, tangent ``da``; ``q = a / b``):

- ``a +- b``: ``da +- db``;  ``-a``: ``-da``;
- ``a * b``: ``da * b + a * db``;
- ``a / b``: ``(da - q * db) / b``;  ``c / b`` for a constant ``c``:
  ``-(q * db) / b``;
- ``log a``: ``da / a``;  ``exp a``: ``da * exp(a)``;
- ``a ** p`` for a number ``p``: ``da * (p a^{p-1})``.

A Dual's value and tangents may themselves be Duals (a nested Dual, of a
higher :attr:`Dual.level`): K11a's twin takes the Jacobian of a model
without a hand-written one (:func:`rodeo_tpu_torch.models.own_block_jacobian`)
on states that already carry theta's tangents, as the kernel's
``DualT<Dual>`` does.  A Dual of a lower level mixed with one of a higher
level is a constant to it; where two Duals of one level have values of
different ranks, the tangents of the lower-ranked one are aligned to the
result's axes (the directions lead), as a nested Dual's tangent, of the
direction's axis more, meets a value.

``torch.cat`` and ``torch.stack`` of Duals and constants stack values and
tangents alike, so a block-form ODE written with them runs on Duals too
(:func:`rodeo_tpu_torch.interrogate.interrogate_kramer`'s forward mode,
:func:`rodeo_tpu_torch.models.own_block_jacobian`).
"""
import torch

__all__ = ["Dual", "Jet2", "primal", "seed_directions", "constant", "rows",
           "stack", "split"]


class Dual:
    """A value ``v`` with tangents ``d`` of shape ``(n_dir,) + v.shape``
    (or broadcastable to it); ``v`` and ``d`` are tensors, or Duals of one
    level less."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v = v
        self.d = d

    @property
    def shape(self):
        return self.v.shape

    @property
    def ndim(self):
        return self.v.ndim

    @property
    def level(self):
        """1 for a Dual of tensors, one more for each nesting."""
        return 1 + (self.v.level if isinstance(self.v, Dual) else 0)

    @property
    def n_dir(self):
        return self.d.shape[0]

    def __len__(self):
        return self.v.shape[0]

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return Dual(self.v[idx], self.d[(slice(None),) + idx])

    def _same(self, o):
        """True where ``o`` is a Dual of this level, False where it is a
        constant to it (not a Dual, or one of a lower level), None where it
        is a Dual of a higher level, whose reflected rule applies (called
        directly: Python calls no reflected method between two operands of
        one class)."""
        if not isinstance(o, Dual):
            return False
        lo, ls = o.level, self.level
        return True if lo == ls else (False if lo < ls else None)

    def __add__(self, o):
        same = self._same(o)
        if same is None:
            return o.__radd__(self)
        if same:
            v = self.v + o.v
            da, db = _tans(self, o, v)
            return Dual(v, da + db)
        return Dual(self.v + o, self.d)

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        same = self._same(o)
        if same is None:
            return o.__rsub__(self)
        if same:
            v = self.v - o.v
            da, db = _tans(self, o, v)
            return Dual(v, da - db)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        same = self._same(o)
        if same is None:
            return o.__rmul__(self)
        if same:
            v = self.v * o.v
            da, db = _tans(self, o, v)
            return Dual(v, da * o.v + self.v * db)
        return Dual(self.v * o, self.d * o)

    def __rmul__(self, o):
        return Dual(o * self.v, o * self.d)

    def __truediv__(self, o):
        same = self._same(o)
        if same is None:
            return o.__rtruediv__(self)
        if same:
            q = self.v / o.v
            da, db = _tans(self, o, q)
            return Dual(q, (da - q * db) / o.v)
        return Dual(self.v / o, self.d / o)

    def __rtruediv__(self, o):
        q = o / self.v
        return Dual(q, -(q * self.d) / self.v)

    def __pow__(self, p):
        if isinstance(p, (Dual, torch.Tensor)):
            return NotImplemented
        return Dual(self.v ** p, self.d * (p * self.v ** (p - 1)))

    def log(self):
        return Dual(torch.log(self.v), self.d / self.v)

    def exp(self):
        e = torch.exp(self.v)
        return Dual(e, self.d * e)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.cat:
            return _cat(*args, **kwargs)
        if func is torch.stack:
            return _stack(*args, **kwargs)
        if func is torch.log:
            return args[0].log()
        if func is torch.exp:
            return args[0].exp()
        if func in (torch.ones_like, torch.zeros_like):
            x = args[0]
            return Dual(func(x.v), torch.zeros_like(x.d))
        if func is torch.broadcast_to:
            x, shape = args[0], tuple(args[1])
            return Dual(torch.broadcast_to(x.v, shape), torch.broadcast_to(
                _lift(x.d, len(shape) - x.ndim), (x.n_dir,) + shape))
        # a plain tensor on the left of an operator: the Dual's reflected
        # rule
        reflected = _REFLECTED.get(getattr(func, "__name__", ""))
        if reflected and len(args) == 2 and isinstance(args[1], Dual):
            return getattr(args[1], reflected)(args[0])
        return NotImplemented


def _expand(x, axis, k):
    """``x`` with ``k`` axes of length 1 inserted at ``axis`` (of a Dual's
    value; its tangents' one further)."""
    if isinstance(x, Dual):
        return Dual(_expand(x.v, axis, k), _expand(x.d, axis + 1, k))
    return x.reshape(tuple(x.shape[:axis]) + (1,) * k
                     + tuple(x.shape[axis:]))


def _lift(d, k):
    """Tangents ``d`` with ``k`` value axes of length 1 inserted after the
    directions' axis."""
    return _expand(d, 1, k) if k > 0 else d


def _tans(a, b, result):
    """The tangents of Duals ``a`` and ``b`` of one level, aligned to the
    value ``result`` of a rule between them where both carry a tangent
    axis per value axis (else as they are: a Dual whose tangents a
    parameter broadcast short of an axis stays short, and
    :func:`rodeo_tpu_torch.interrogate._dual_jacobian` sees it)."""
    if a.d.ndim != a.ndim + 1 or b.d.ndim != b.ndim + 1:
        return a.d, b.d
    return (_lift(a.d, result.ndim - a.ndim),
            _lift(b.d, result.ndim - b.ndim))


# Tensor methods that meet a Dual as their second operand, and the Dual's
# reflected rule for each
_REFLECTED = {"add": "__radd__", "sub": "__rsub__", "mul": "__rmul__",
              "div": "__rtruediv__"}


def _stack(tensors, dim=0):
    """``torch.stack`` of Duals and constants on a new value axis."""
    n_dir = next(x.n_dir for x in tensors if isinstance(x, Dual))
    vs = [primal(x) for x in tensors]
    ds = [torch.broadcast_to(x.d, (n_dir,) + x.v.shape) if isinstance(x, Dual)
          else x.new_zeros((n_dir,) + x.shape) for x in tensors]
    return Dual(torch.stack(vs, dim), torch.stack(ds, dim + 1 if dim >= 0
                                                  else dim))


def _cat(tensors, dim=0):
    """``torch.cat`` of Duals and constants along a value axis."""
    n_dir = next(x.n_dir for x in tensors if isinstance(x, Dual))
    vs = [primal(x) for x in tensors]
    ds = [torch.broadcast_to(x.d, (n_dir,) + x.v.shape) if isinstance(x, Dual)
          else x.new_zeros((n_dir,) + x.shape) for x in tensors]
    return Dual(torch.cat(vs, dim), torch.cat(ds, dim + 1 if dim >= 0
                                              else dim))


class Jet2:
    r"""
    A second-order forward number along one direction: a value ``v``, its
    first derivative ``d1`` and its second ``d2``.  Evaluating a function on
    ``Jet2(x, 1, 0)`` gives ``f(x)``, ``f'(x)`` and ``f''(x)``: the gradient
    and Hessian of an observation model's Laplace linearisation.

    The components are plain tensors, or :class:`Dual`\ s in the tangent
    kernel's twin, where the tangent of ``f''`` carries the third
    derivative.  Anything that is not a Jet2 is a constant.  The rules are
    written once here and once in ``csrc/jet.cuh``, in the same order
    (``a``, ``b`` Jet2s with components ``a0, a1, a2``; ``c`` a constant;
    ``q = a0 / b0``, ``q1`` the first component of a quotient):

    - ``a +- b``, ``-a``: componentwise;  ``a +- c``: ``(a0 +- c, a1, a2)``;
    - ``a * b``: ``(a0 b0, a1 b0 + a0 b1, (a2 b0 + a0 b2) + (a1 b1 + a1
      b1))``;  ``a * c``: each component times ``c``;
    - ``a / b``: ``(q, (a1 - q b1) / b0, (a2 - (q1 b1 + q1 b1) - q b2) /
      b0)``;  ``a / c``: each component over ``c``;  ``c / b``: ``(q,
      -(q b1) / b0, -((q1 b1 + q1 b1) + q b2) / b0)``;
    - ``exp a``: ``(e, e a1, e (a2 + a1 a1))``, ``e = exp(a0)``;
    - ``log a``: ``(log a0, q1, (a2 - q1 a1) / a0)``, ``q1 = a1 / a0``.
    """

    __slots__ = ("v", "d1", "d2")

    def __init__(self, v, d1, d2):
        self.v, self.d1, self.d2 = v, d1, d2

    def __add__(self, o):
        if isinstance(o, Jet2):
            return Jet2(self.v + o.v, self.d1 + o.d1, self.d2 + o.d2)
        return Jet2(self.v + o, self.d1, self.d2)

    def __radd__(self, o):
        return Jet2(o + self.v, self.d1, self.d2)

    def __sub__(self, o):
        if isinstance(o, Jet2):
            return Jet2(self.v - o.v, self.d1 - o.d1, self.d2 - o.d2)
        return Jet2(self.v - o, self.d1, self.d2)

    def __rsub__(self, o):
        return Jet2(o - self.v, -self.d1, -self.d2)

    def __neg__(self):
        return Jet2(-self.v, -self.d1, -self.d2)

    def __mul__(self, o):
        if isinstance(o, Jet2):
            return Jet2(self.v * o.v, self.d1 * o.v + self.v * o.d1,
                        (self.d2 * o.v + self.v * o.d2)
                        + (self.d1 * o.d1 + self.d1 * o.d1))
        return Jet2(self.v * o, self.d1 * o, self.d2 * o)

    def __rmul__(self, o):
        return Jet2(o * self.v, o * self.d1, o * self.d2)

    def __truediv__(self, o):
        if isinstance(o, Jet2):
            q = self.v / o.v
            q1 = (self.d1 - q * o.d1) / o.v
            q2 = (self.d2 - (q1 * o.d1 + q1 * o.d1) - q * o.d2) / o.v
            return Jet2(q, q1, q2)
        return Jet2(self.v / o, self.d1 / o, self.d2 / o)

    def __rtruediv__(self, o):
        q = o / self.v
        q1 = -(q * self.d1) / self.v
        q2 = -((q1 * self.d1 + q1 * self.d1) + q * self.d2) / self.v
        return Jet2(q, q1, q2)

    def exp(self):
        e = self.v.exp()
        return Jet2(e, e * self.d1, e * (self.d2 + self.d1 * self.d1))

    def log(self):
        q1 = self.d1 / self.v
        return Jet2(self.v.log(), q1, (self.d2 - q1 * self.d1) / self.v)


def primal(x):
    """The value of a Dual; anything else as it is."""
    return x.v if isinstance(x, Dual) else x


def seed_directions(theta_lanes):
    """``theta_lanes (n_theta, B)`` as a Dual along the ``n_theta`` basis
    directions: direction ``k`` moves ``theta_k`` alone."""
    n_theta = theta_lanes.shape[0]
    eye = torch.eye(n_theta, dtype=theta_lanes.dtype,
                    device=theta_lanes.device)
    return Dual(theta_lanes, eye[:, :, None].expand(
        (n_theta,) + tuple(theta_lanes.shape)))


def constant(x, n_dir):
    """``x`` as a Dual with zero tangents along ``n_dir`` directions."""
    return Dual(x, x.new_zeros((n_dir,) + tuple(x.shape)))


def rows(x):
    """A Dual as ``(1 + n_dir, ...)``: its value, then its tangent along
    each direction; anything else as it is."""
    if not isinstance(x, Dual):
        return x
    d = torch.broadcast_to(x.d, (x.n_dir,) + tuple(x.v.shape))
    return torch.cat([x.v[None], d])


def stack(cols):
    """Stack columns on a new leading axis: ``torch.stack`` of plain
    tensors, and for Duals the layout of the tangent kernels, the values
    ``(K, ...)`` followed by each direction's ``(K, ...)``, i.e.
    ``(n_aug K, ...)`` with ``n_aug = 1 + n_dir``."""
    if not any(isinstance(c, Dual) for c in cols):
        return torch.stack(cols)
    n_dir = next(c.n_dir for c in cols if isinstance(c, Dual))
    v = torch.stack([primal(c) for c in cols])
    d = torch.stack([torch.broadcast_to(c.d, (n_dir,) + c.v.shape)
                     if isinstance(c, Dual)
                     else c.new_zeros((n_dir,) + c.shape) for c in cols],
                    dim=1)
    return torch.cat([v, d.reshape((n_dir * len(cols),) + v.shape[1:])])


def split(aug, k, axis=0):
    """The inverse of :func:`stack` along ``axis``: ``aug`` with
    ``n_aug k`` entries there becomes one Dual whose value has ``k``."""
    aug = aug.movedim(axis, 0)
    n_dir = aug.shape[0] // k - 1
    v = aug[:k]
    d = aug[k:].reshape((n_dir, k) + tuple(aug.shape[1:]))
    return Dual(v.movedim(0, axis), d.movedim(1, axis + 1))
