"""Batched forward-mode differentiation: a value with K tangent columns.

``Dual(v, t)`` carries a tensor value ``v`` (*S) and its derivative along K
directions at once, ``t`` (K, *S).  Torch functions and operators applied to
a Dual (``__torch_function__``) return the value and the pushed-forward
tangents; plain tensors and Python numbers are constants.  ``jacfwd(f,
x)`` evaluates ``f`` once on ``Dual(x, I)`` and returns every column of
the Jacobian from that one pass.

Why not ``torch.autograd.forward_ad`` or ``torch.func.jacfwd`` for the
Jacobians of ``calibrate`` and ``femu``: they push one column at a time
(or vmap over columns, which the BiCGStab of ``femu`` with its host reads
cannot take), and every operation pays their per-op dispatch on the host;
a Dual pushes all columns through each plain operation at once.
``python -m pylabfea_tpu_torch.profile_fwd`` times the three on
``calibrate.simulate_paths``.  The implicit steps of ``calibrate`` and
``femu`` are ``torch.autograd.Function`` s whose ``jvp`` runs the same
tangent solve on a one-column Dual, so ``forward_ad`` and ``torch.func.jvp``
reach them too.

Only the operations of the analytic return map, the backward-Euler
residual and the flat FE operator are covered; any other raises
``NotImplementedError`` naming it.  Ties of ``maximum`` and ``max`` split
the derivative between the equal operands, as JAX's rules do.
"""
import torch

_HANDLERS = {}


def _register(*funcs):
    def deco(fn):
        for f in funcs:
            _HANDLERS[f] = fn
        return fn
    return deco


class Dual:
    """A value (*S) and K tangents (K, *S)."""
    __slots__ = ('v', 't')

    def __init__(self, v, t):
        self.v = v
        self.t = t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        fn = _HANDLERS.get(func)
        if fn is None:
            raise NotImplementedError(f'Dual: no forward rule for {func}')
        return fn(*args, **(kwargs or {}))

    # attributes --------------------------------------------------
    shape = property(lambda self: self.v.shape)
    dtype = property(lambda self: self.v.dtype)
    device = property(lambda self: self.v.device)
    ndim = property(lambda self: self.v.ndim)
    T = property(lambda self: transpose(self, -1, -2))

    def __repr__(self):
        return f'Dual(v={self.v!r}, t.shape={tuple(self.t.shape)})'

    # constructors of constants -----------------------------------
    def new_zeros(self, *a, **k):
        return self.v.new_zeros(*a, **k)

    def new_ones(self, *a, **k):
        return self.v.new_ones(*a, **k)

    # operators ---------------------------------------------------
    def __add__(self, o):
        return add(self, o)

    def __radd__(self, o):
        return add(o, self)

    def __sub__(self, o):
        return sub(self, o)

    def __rsub__(self, o):
        return sub(o, self)

    def __mul__(self, o):
        return mul(self, o)

    def __rmul__(self, o):
        return mul(o, self)

    def __truediv__(self, o):
        return div(self, o)

    def __rtruediv__(self, o):
        return div(o, self)

    def __matmul__(self, o):
        return matmul(self, o)

    def __rmatmul__(self, o):
        return matmul(o, self)

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __pow__(self, p):
        return pow_(self, p)

    def __abs__(self):
        return abs_(self)

    def __getitem__(self, idx):
        return getitem(self, idx)

    def __lt__(self, o):
        return self.v < value(o)

    def __le__(self, o):
        return self.v <= value(o)

    def __gt__(self, o):
        return self.v > value(o)

    def __ge__(self, o):
        return self.v >= value(o)

    def __eq__(self, o):
        return self.v == value(o)

    def __ne__(self, o):
        return self.v != value(o)

    __hash__ = None

    # methods -----------------------------------------------------
    def reshape(self, *shape):
        return reshape(self, *shape)

    view = reshape

    def transpose(self, a, b):
        return transpose(self, a, b)

    def mean(self, dim=None, keepdim=False):
        return mean(self, dim, keepdim)


def _shape_arg(shape):
    """A shape given as ``f(2, 3)`` or ``f((2, 3))`` as a tuple."""
    if len(shape) == 1 and not isinstance(shape[0], int):
        return tuple(shape[0])
    return tuple(shape)


def value(x):
    """The value of a Dual; anything else as it is."""
    return x.v if isinstance(x, Dual) else x


def is_dual(*xs):
    return any(isinstance(x, Dual) for x in xs)


def _td(d, ndim):
    """A value dimension as a dimension of the tangent (its own ndim)."""
    return d + 1 if d >= 0 else d


def _lift(x, ndim):
    """Tangent of ``x`` with its value dims right-aligned to ``ndim``."""
    t = x.t
    if x.v.ndim == ndim:
        return t
    return t.reshape(t.shape[0], *([1] * (ndim - x.v.ndim)), *x.v.shape)


def _tan(x, out):
    """Tangent of operand ``x`` broadcast to the output ``out`` (or None
    for a constant)."""
    if not isinstance(x, Dual):
        return None
    if x.v.shape == out.shape:
        return x.t
    t = _lift(x, out.ndim)
    return t.expand(t.shape[0], *out.shape)


def _sum_t(*ts):
    ts = [t for t in ts if t is not None]
    out = ts[0]
    for t in ts[1:]:
        out = out + t
    return out


def _k_of(*xs):
    for x in xs:
        if isinstance(x, Dual):
            return x.t.shape[0]
    return None


@_register(torch.add, torch.Tensor.add, torch.Tensor.__add__,
           torch.Tensor.__radd__)
def add(a, b, alpha=1):
    if alpha != 1:
        b = mul(b, alpha)
    v = value(a) + value(b)
    return Dual(v, _sum_t(_tan(a, v), _tan(b, v)))


@_register(torch.sub, torch.Tensor.sub, torch.Tensor.__sub__)
def sub(a, b):
    v = value(a) - value(b)
    ta, tb = _tan(a, v), _tan(b, v)
    return Dual(v, ta if tb is None else (-tb if ta is None else ta - tb))


@_register(torch.Tensor.__rsub__)
def _rsub(a, b):
    return sub(b, a)


@_register(torch.mul, torch.Tensor.mul, torch.Tensor.__mul__,
           torch.Tensor.__rmul__)
def mul(a, b):
    va, vb = value(a), value(b)
    v = va * vb
    ta, tb = _tan(a, v), _tan(b, v)
    return Dual(v, _sum_t(None if ta is None else ta * vb,
                          None if tb is None else va * tb))


@_register(torch.div, torch.true_divide, torch.Tensor.div,
           torch.Tensor.__truediv__)
def div(a, b):
    va, vb = value(a), value(b)
    v = va / vb
    ta, tb = _tan(a, v), _tan(b, v)
    return Dual(v, _sum_t(None if ta is None else ta / vb,
                          None if tb is None else -(v * tb) / vb))


@_register(torch.Tensor.__rtruediv__)
def _rdiv(a, b):
    return div(b, a)


@_register(torch.pow, torch.Tensor.pow, torch.Tensor.__pow__)
def pow_(a, p):
    if isinstance(p, Dual):
        raise NotImplementedError('Dual: a dual exponent')
    v = a.v ** p
    return Dual(v, a.t * (p * a.v ** (p - 1)))


@_register(torch.abs, torch.Tensor.abs, torch.Tensor.__abs__)
def abs_(a):
    return Dual(torch.abs(a.v), a.t * torch.sign(a.v))


@_register(torch.sqrt, torch.Tensor.sqrt)
def sqrt(a):
    v = torch.sqrt(a.v)
    return Dual(v, a.t * (0.5 / v))


@_register(torch.exp, torch.Tensor.exp)
def exp(a):
    v = torch.exp(a.v)
    return Dual(v, a.t * v)


@_register(torch.expm1, torch.Tensor.expm1)
def expm1(a):
    v = torch.expm1(a.v)
    return Dual(v, a.t * torch.exp(a.v))


@_register(torch.logaddexp)
def logaddexp(a, b):
    va, vb = value(a), value(b)
    v = torch.logaddexp(va, vb)
    ta, tb = _tan(a, v), _tan(b, v)
    return Dual(v, _sum_t(None if ta is None else ta * torch.exp(va - v),
                          None if tb is None else tb * torch.exp(vb - v)))


@_register(torch.where)
def where(c, a, b):
    c = value(c)
    v = torch.where(c, value(a), value(b))
    ta, tb = _tan(a, v), _tan(b, v)
    k = _k_of(a, b)
    z = v.new_zeros(())
    return Dual(v, torch.where(c, z if ta is None else ta,
                               z if tb is None else tb).expand(k, *v.shape))


@_register(torch.maximum)
def maximum(a, b):
    va, vb = value(a), value(b)
    v = torch.maximum(va, vb)
    ta, tb = _tan(a, v), _tan(b, v)
    k = _k_of(a, b)
    z = v.new_zeros(())
    ta = z if ta is None else ta
    tb = z if tb is None else tb
    t = torch.where(va > vb, ta, torch.where(va < vb, tb, 0.5 * (ta + tb)))
    return Dual(v, t.expand(k, *v.shape))


@_register(torch.clamp, torch.clip, torch.Tensor.clamp)
def clamp(a, min=None, max=None):
    if is_dual(min, max):
        raise NotImplementedError('Dual: clamp with dual bounds')
    v = torch.clamp(a.v, min=min, max=max)
    inside = torch.ones_like(a.v, dtype=torch.bool)
    if min is not None:
        inside = inside & (a.v > min)
    if max is not None:
        inside = inside & (a.v < max)
    return Dual(v, torch.where(inside, a.t, 0.))


@_register(torch.max, torch.amax)
def max_(a, *rest, **kw):
    if rest or kw:
        raise NotImplementedError('Dual: max over a dimension')
    v = torch.max(a.v)
    hit = (a.v == v).to(a.v.dtype)
    t = torch.sum(a.t * hit, dim=tuple(range(1, a.t.ndim))) / torch.sum(hit)
    return Dual(v, t)


def _dims(dim, ndim):
    if dim is None:
        return tuple(range(1, ndim + 1))
    if isinstance(dim, int):
        dim = (dim,)
    return tuple(_td(d, ndim) for d in dim)


@_register(torch.sum, torch.Tensor.sum)
def sum_(a, dim=None, keepdim=False):
    if a.v.ndim == 0:
        return a
    if dim is None:
        return Dual(torch.sum(a.v), torch.sum(a.t, dim=_dims(None, a.v.ndim)))
    return Dual(torch.sum(a.v, dim=dim, keepdim=keepdim),
                torch.sum(a.t, dim=_dims(dim, a.v.ndim), keepdim=keepdim))


@_register(torch.mean, torch.Tensor.mean)
def mean(a, dim=None, keepdim=False):
    out = sum_(a, dim, keepdim)
    return div(out, a.v.numel() // max(out.v.numel(), 1))


@_register(torch.stack)
def stack(xs, dim=0):
    v = torch.stack([value(x) for x in xs], dim=dim)
    k = _k_of(*xs)
    ts = [x.t if isinstance(x, Dual) else
          x.new_zeros(()).expand(k, *x.shape) for x in xs]
    return Dual(v, torch.stack(ts, dim=_td(dim, v.ndim)))


@_register(torch.cat, torch.concat)
def cat(xs, dim=0):
    v = torch.cat([value(x) for x in xs], dim=dim)
    k = _k_of(*xs)
    ts = [x.t if isinstance(x, Dual) else
          x.new_zeros(()).expand(k, *x.shape) for x in xs]
    return Dual(v, torch.cat(ts, dim=_td(dim, v.ndim)))


@_register(torch.Tensor.__rmatmul__)
def _rmatmul(a, b):
    return matmul(b, a)


@_register(torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
def matmul(a, b):
    va, vb = value(a), value(b)
    v = va @ vb
    parts = []
    if isinstance(a, Dual):
        parts.append(a.t @ vb)
    if isinstance(b, Dual):
        parts.append((va @ b.t.unsqueeze(-1)).squeeze(-1) if vb.ndim == 1
                     else va @ b.t)
    return Dual(v, _sum_t(*parts).expand(_k_of(a, b), *v.shape))


@_register(torch.einsum)
def einsum(eq, *ops):
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    lhs, out = eq.replace(' ', '').split('->')
    specs = lhs.split(',')
    vals = [value(o) for o in ops]
    v = torch.einsum(eq, *vals)
    free = next(c for c in 'ZYXWVUTSRQPONMLKJIHGFEDCBA' if c not in eq)
    parts = []
    for i, o in enumerate(ops):
        if isinstance(o, Dual):
            sp = list(specs)
            sp[i] = free + sp[i]
            args = vals[:i] + [o.t] + vals[i + 1:]
            parts.append(torch.einsum(','.join(sp) + '->' + free + out,
                                      *args))
    return Dual(v, _sum_t(*parts))


@_register(torch.index_add, torch.Tensor.index_add)
def index_add(a, dim, index, source):
    v = value(a).index_add(dim, index, value(source))
    k = _k_of(a, source)
    t = a.t if isinstance(a, Dual) else v.new_zeros((k,) + v.shape)
    if isinstance(source, Dual):
        t = t.index_add(_td(dim % v.ndim, v.ndim), index, source.t)
    return Dual(v, t)


@_register(torch.Tensor.__getitem__)
def getitem(a, idx):
    if isinstance(idx, Dual):
        raise NotImplementedError('Dual: a dual index')
    tidx = (slice(None),) + (idx if isinstance(idx, tuple) else (idx,))
    return Dual(a.v[idx], a.t[tidx])


@_register(torch.reshape, torch.Tensor.reshape, torch.Tensor.view)
def reshape(a, *shape):
    v = a.v.reshape(_shape_arg(shape))
    return Dual(v, a.t.reshape(a.t.shape[0], *v.shape))


@_register(torch.transpose, torch.Tensor.transpose)
def transpose(a, d0, d1):
    nd = a.v.ndim
    return Dual(a.v.transpose(d0, d1),
                a.t.transpose(_td(d0 % nd, nd), _td(d1 % nd, nd)))


@_register(torch.roll, torch.Tensor.roll)
def roll(a, shifts, dims):
    nd = a.v.ndim
    return Dual(torch.roll(a.v, shifts, dims),
                torch.roll(a.t, shifts, _td(dims % nd, nd)))


@_register(torch.diag)
def diag(a):
    if a.v.ndim != 1:
        raise NotImplementedError('Dual: diag of a matrix')
    return Dual(torch.diag(a.v), torch.diag_embed(a.t))


@_register(torch.diagonal, torch.Tensor.diagonal)
def diagonal(a, offset=0, dim1=0, dim2=1):
    nd = a.v.ndim
    return Dual(torch.diagonal(a.v, offset, dim1, dim2),
                torch.diagonal(a.t, offset, _td(dim1 % nd, nd),
                               _td(dim2 % nd, nd)))


@_register(torch.zeros_like)
def zeros_like(a, **kw):
    return torch.zeros_like(value(a), **kw)


@_register(torch.Tensor.__lt__, torch.lt)
def _lt(a, b):
    return value(a) < value(b)


@_register(torch.Tensor.__le__, torch.le)
def _le(a, b):
    return value(a) <= value(b)


@_register(torch.Tensor.__gt__, torch.gt)
def _gt(a, b):
    return value(a) > value(b)


@_register(torch.Tensor.__ge__, torch.ge)
def _ge(a, b):
    return value(a) >= value(b)


@_register(torch.Tensor.__eq__, torch.eq)
def _eq(a, b):
    return value(a) == value(b)


def seed(x, t=None):
    """``x`` as a Dual with tangents ``t`` (default: the identity over the
    entries of ``x``, one column each)."""
    if t is None:
        n = x.numel()
        t = torch.eye(n, dtype=x.dtype, device=x.device).reshape(n, *x.shape)
    return Dual(x, t)


def jacfwd(f, x):
    """(f(x), J) for a tensor-valued ``f`` of a tensor ``x``: J (f.numel(),
    x.numel()) from one evaluation of ``f`` on ``seed(x)``."""
    y = f(seed(x))
    if not isinstance(y, Dual):
        return y, y.new_zeros((y.numel(), x.numel()))
    return y.v, y.t.reshape(y.t.shape[0], -1).T
