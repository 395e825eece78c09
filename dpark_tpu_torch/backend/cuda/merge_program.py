"""A traced user merge lowered into a small register program: the input
of K14 (kernels.segmented_merge, csrc/segmented_merge.cu) and, evaluated
in torch, of its plain version.

lower(merge_leaves, specs) traces the leaf-list merge

    merge_leaves(a leaves, b leaves) -> merged leaves

with torch.fx's make_fx over TRACE_ROWS example rows, under
fuse.python_float_semantics (so every dtype is the one the vmapped merge
computes).  a and b get distinct example tensors: given one tensor for
both, make_fx traces a graph that reads b twice.  Each leaf of shape W
is W slots (its lanes, C order); a slot of a and its slot of b are two
64-bit registers.  Every graph value is an array of registers (the
traced shape with the batch dimension cut to 1), so the view ops of
vmap's batching and of lane indexing (view, reshape, squeeze,
unsqueeze, expand, select) only rearrange registers, and an elementwise
op emits one instruction per element:

  add sub mul div floordiv rem neg abs min max where
  eq ne lt le gt ge  land lor lxor lnot  band bor bxor bnot  cast

Each instruction computes in the dtype of its node's meta["val"] (a
comparison in the inputs' promoted dtype); explicit casts stand where
aten promotes.  A node whose inputs are all constants is folded by
running it; constants (Python scalars, the merge's own tensors, the
Python numbers it returns, _as_leaf in fuse.py) are registers loaded
once.  Each result is cast to its leaf's dtype, as segmented_combine
does.  Division by zero on integers gives 0 (torch's CUDA floor_divide;
torch's CPU raises).

A merge outside that set is not lowered, and the reason is kept: an op
outside it (a reduction over a vector leaf's lanes, a matmul, a
data-dependent op), a value that does not trace, more than MAX_SLOTS
slots, MAX_INSTRS instructions or MAX_REGS registers.
"""

import inspect

import numpy as np
import torch

MAX_SLOTS = 16
MAX_REGS = 96
MAX_INSTRS = 256
TRACE_ROWS = 7      # the traced batch: a size no lane count is likely to be
WORDS = 6           # int32 words an instruction: op, dtype, dst, a, b, c

# dtype codes, shared with csrc/segmented_merge.cu
I64, I32, F64, F32, BOOL = range(5)
CODE = {torch.int64: I64, torch.int32: I32, torch.float64: F64,
        torch.float32: F32, torch.bool: BOOL}
DTYPE = {v: k for k, v in CODE.items()}

# opcodes, shared with csrc/segmented_merge.cu
(ADD, SUB, MUL, DIV, FLOORDIV, REM, NEG, ABS, MIN, MAX, WHERE, EQ, NE, LT,
 LE, GT, GE, LAND, LOR, LXOR, LNOT, BAND, BOR, BXOR, BNOT, CAST) = range(26)
OP_NAMES = ("add sub mul div floordiv rem neg abs min max where eq ne lt le "
            "gt ge land lor lxor lnot band bor bxor bnot cast").split()
COMPARE = (EQ, NE, LT, LE, GT, GE)
LOGICAL = (LAND, LOR, LXOR, LNOT)

K14 = "K14"
# a lane-separable program: K14 folds each slot with its op, no interpreter
K14_SEPARABLE = "K14 separable"
SEPARABLE = (ADD, MIN, MAX, MUL)


class NotLowered(Exception):
    """The merge has no program; the message says why."""


def _aten(name):
    packet, _, overload = name.partition(".")
    return getattr(getattr(torch.ops.aten, packet), overload or "default")


def _targets(names):
    out = {}
    for name, v in names.items():
        for n in name.split():
            try:
                out[_aten(n)] = v
            except AttributeError:      # an overload this torch lacks
                pass
    return out


# aten overloads -> (opcode, operand count); the overloads are those the
# traces of vmapped merges give (tests/test_torch_merge_program.py)
_ELEMENTWISE = _targets({
    "add.Tensor add.Scalar": (ADD, 2),
    "sub.Tensor sub.Scalar": (SUB, 2),
    "rsub.Tensor rsub.Scalar": ("rsub", 2),
    "mul.Tensor mul.Scalar": (MUL, 2),
    "div.Tensor div.Scalar": (DIV, 2),
    "div.Tensor_mode div.Scalar_mode": ("div_mode", 2),
    "floor_divide.default floor_divide.Scalar": (FLOORDIV, 2),
    "remainder.Tensor remainder.Scalar remainder.Scalar_Tensor": (REM, 2),
    "neg.default": (NEG, 1),
    "abs.default": (ABS, 1),
    "minimum.default": (MIN, 2),
    "maximum.default": (MAX, 2),
    "where.self where.ScalarSelf where.ScalarOther where.Scalar":
        (WHERE, 3),
    "eq.Tensor eq.Scalar": (EQ, 2), "ne.Tensor ne.Scalar": (NE, 2),
    "lt.Tensor lt.Scalar": (LT, 2), "le.Tensor le.Scalar": (LE, 2),
    "gt.Tensor gt.Scalar": (GT, 2), "ge.Tensor ge.Scalar": (GE, 2),
    "logical_and.default": (LAND, 2), "logical_or.default": (LOR, 2),
    "logical_xor.default": (LXOR, 2), "logical_not.default": (LNOT, 1),
    "bitwise_and.Tensor bitwise_and.Scalar": (BAND, 2),
    "bitwise_or.Tensor bitwise_or.Scalar": (BOR, 2),
    "bitwise_xor.Tensor bitwise_xor.Scalar": (BXOR, 2),
    "bitwise_not.default": (BNOT, 1),
})
_IDENTITY = _targets({"clone.default alias.default detach.default "
                      "lift_fresh_copy.default contiguous.default": 1})
_RESHAPES = _targets({"view.default _unsafe_view.default reshape.default "
                      "squeeze.default squeeze.dim squeeze.dims "
                      "unsqueeze.default": 1})


def _const_bits(value, code):
    """A constant as the kernel's 64-bit register word."""
    if code == F64:
        return int(np.array(value, np.float64).view(np.int64))
    if code == F32:
        return int(np.array(value, np.float32).view(np.uint32))
    return int(value)


class Program:
    """Straight-line code over registers: a's slots are registers [0, S),
    b's [S, 2S), then constants, then temporaries.  `out[j]` holds the
    merged slot j after the code runs."""

    def __init__(self, specs, code, consts, out, nregs):
        self.specs = specs          # [(torch dtype, lane shape)] per leaf
        self.code = code            # [(op, dtype code, dst, a, b, c)]
        self.consts = consts        # [(reg, dtype code, python value)]
        self.out = out              # [reg] per slot
        self.nregs = nregs
        self.slot_dtypes = [dt for dt, shp in specs
                            for _ in range(int(np.prod(shp, dtype=int)))]
        self.nslots = len(self.slot_dtypes)
        self._device_words = {}
        self._separable = self._lane_ops()

    def __repr__(self):
        lines = ["Program(%d slots, %d registers)" % (self.nslots,
                                                       self.nregs)]
        for reg, c, v in self.consts:
            lines.append("  r%d = %r (%s)" % (reg, v, DTYPE[c]))
        for op, c, d, a, b, x in self.code:
            lines.append("  r%d = %s.%s r%d r%d %d" % (
                d, OP_NAMES[op], DTYPE[c], a, b, x))
        lines.append("  out: %s" % self.out)
        return "\n".join(lines)

    def words(self):
        """The kernel's int64 program buffer: [instructions, constants,
        slots], then 6 words an instruction, (register, bits) a constant,
        the output register of each slot."""
        w = [len(self.code), len(self.consts), self.nslots]
        for ins in self.code:
            w.extend(ins)
        for reg, c, v in self.consts:
            w.extend((reg, _const_bits(v, c)))
        w.extend(self.out)
        return np.asarray(w, dtype=np.int64)

    def device_words(self, device):
        """words() on `device`, uploaded once."""
        key = str(device)
        if key not in self._device_words:
            self._device_words[key] = torch.from_numpy(self.words()).to(
                device)
        return self._device_words[key]

    def separable_ops(self):
        """[(op, dtype code)] per slot when the program is lane-separable:
        no constants, and every merged slot j is one instruction op(a_j,
        b_j) in the slot's own dtype, op in SEPARABLE (K14 then folds each
        slot with its op, without the interpreter); else None."""
        return self._separable

    def _lane_ops(self):
        S = self.nslots
        if self.consts or len(self.code) != S or len(set(self.out)) != S:
            return None
        by_dst = {ins[2]: ins for ins in self.code}
        ops = []
        for j, (reg, dt) in enumerate(zip(self.out, self.slot_dtypes)):
            op, code, _, a, b, _ = by_dst.get(reg, (None,) * 6)
            if op not in SEPARABLE or code != CODE[dt] or (a, b) != (j, S + j):
                return None
            ops.append((op, code))
        return ops

    # ---- the torch evaluator (the plain version's merge) -------------
    def eval_slots(self, a, b):
        """The merged slots of rows a, b (lists of (M,) slot tensors)."""
        dev, rows = a[0].device, a[0].shape[0]
        r = [None] * self.nregs
        S = self.nslots
        r[:S], r[S:2 * S] = list(a), list(b)
        for reg, c, v in self.consts:
            r[reg] = torch.tensor(v, dtype=DTYPE[c], device=dev)
        for op, c, d, x, y, z in self.code:
            r[d] = _eval_op(op, DTYPE[c], r[x], r[y],
                            r[z] if op == WHERE else z)
        return [r[o].expand(rows) if r[o].dim() == 0 else r[o]
                for o in self.out]

    def merge_leaves(self, va, vb):
        """eval_slots over leaf lists: (M, *lanes) leaves in and out."""
        out = self.eval_slots(_slots(va), _slots(vb))
        leaves, j = [], 0
        for (dt, shp), v in zip(self.specs, va):
            w = int(np.prod(shp, dtype=int))
            leaves.append(torch.stack(out[j:j + w], 1).reshape(v.shape)
                          if shp else out[j])
            j += w
        return leaves


def _slots(leaves):
    out = []
    for v in leaves:
        if v.dim() == 1:
            out.append(v)
        else:
            out.extend(v.reshape(v.shape[0], -1).unbind(1))
    return out


def _int_div(fn, x, y):
    zero = y == 0
    return torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device),
                       fn(x, torch.where(zero, torch.ones_like(y), y)))


def _eval_op(op, dt, x, y, z):
    if op == CAST:
        return x.to(dt)
    if op == WHERE:
        return torch.where(x, y, z)
    if op == ADD:
        return torch.add(x, y)
    if op == SUB:
        return torch.sub(x, y)
    if op == MUL:
        return torch.mul(x, y)
    if op == DIV:
        return torch.div(x, y)
    if op in (FLOORDIV, REM):
        fn = torch.floor_divide if op == FLOORDIV else torch.remainder
        return fn(x, y) if dt.is_floating_point else _int_div(fn, x, y)
    unary = {NEG: torch.neg, ABS: torch.abs, LNOT: torch.logical_not,
             BNOT: torch.bitwise_not}
    if op in unary:
        return unary[op](x)
    return {MIN: torch.minimum, MAX: torch.maximum, EQ: torch.eq,
            NE: torch.ne, LT: torch.lt, LE: torch.le, GT: torch.gt,
            GE: torch.ge, LAND: torch.logical_and, LOR: torch.logical_or,
            LXOR: torch.logical_xor, BAND: torch.bitwise_and,
            BOR: torch.bitwise_or, BXOR: torch.bitwise_xor}[op](x, y)


# ----------------------------------------------------------------------
# lowering
# ----------------------------------------------------------------------
class _Emitter:
    """SSA registers while lowering; allocate() maps them onto MAX_REGS
    physical registers."""

    def __init__(self, nslots):
        self.dt = []            # dtype code per virtual register
        self.code = []
        self.consts = {}        # (code, bits) -> reg
        self.const_val = {}     # reg -> python value
        self.casts = {}         # (reg, code) -> reg
        self.seen = {}          # instruction -> its register (no twins)
        self.nslots = nslots

    def new(self, code):
        self.dt.append(code)
        return len(self.dt) - 1

    def const(self, t):
        """A register holding the 0-dim tensor t (its own dtype)."""
        if t.dtype not in CODE:
            raise NotLowered("constant of dtype %s" % t.dtype)
        code = CODE[t.dtype]
        v = t.item()
        key = (code, _const_bits(v, code))
        if key not in self.consts:
            reg = self.new(code)
            self.consts[key] = reg
            self.const_val[reg] = v
        return self.consts[key]

    def cast(self, reg, code):
        if self.dt[reg] == code:
            return reg
        if reg in self.const_val:       # fold: torch's own conversion
            return self.const(torch.tensor(
                self.const_val[reg], dtype=DTYPE[self.dt[reg]]).to(
                    DTYPE[code]))
        key = (reg, code)
        if key not in self.casts:
            self.casts[key] = self.emit(CAST, code, code, reg,
                                        reg, self.dt[reg])
        return self.casts[key]

    def emit(self, op, code, out_code, a, b=None, c=0):
        key = (op, code, out_code, a, a if b is None else b, c)
        if key not in self.seen:
            dst = self.new(out_code)
            self.code.append((op, code, dst) + key[3:])
            self.seen[key] = dst
        return self.seen[key]

    def allocate(self, out):
        """Dead-code elimination, then a linear scan of the live ranges:
        inputs and live constants keep their registers; a temporary's
        register is free after its last read.  Returns (code, consts,
        out, nregs)."""
        live = set(out)
        kept = []
        for ins in reversed(self.code):
            if ins[2] in live:
                kept.append(ins)
                live.update(_reads(ins))
        kept.reverse()
        phys = {v: v for v in range(2 * self.nslots)}
        consts = []
        for v in sorted(set(self.const_val) & live):
            phys[v] = len(phys)
            consts.append((phys[v], self.dt[v], self.const_val[v]))
        last = {v: i for i, ins in enumerate(kept) for v in _reads(ins)}
        last.update((v, len(kept)) for v in out)
        free, top, code = [], len(phys), []
        for i, ins in enumerate(kept):
            op, k, d, a, b, c = ins
            free.extend(phys[v] for v in set(_reads(ins))
                        if v >= 2 * self.nslots
                        and v not in self.const_val and last[v] == i)
            if free:
                free.sort()
                phys[d] = free.pop(0)
            else:
                phys[d] = top
                top += 1
            code.append((op, k, phys[d], phys[a], phys[b],
                         phys[c] if op == WHERE else c))
        return code, consts, [phys[v] for v in out], top


def _reads(ins):
    """The registers an instruction reads (a cast's c is a dtype code)."""
    op, _, _, a, b, c = ins
    return (a, b, c) if op == WHERE else (a, b)


def _example(dt, shape, k):
    """Distinct example values of leaf k: nonzero (x // 0 raises on
    the CPU), different in every tensor and lane."""
    n = TRACE_ROWS * int(np.prod(shape, dtype=int))
    base = torch.arange(n, dtype=torch.float64).reshape(
        (TRACE_ROWS,) + tuple(shape))
    if dt == torch.bool:
        return ((base + k) % 2).to(torch.bool)
    if dt.is_floating_point:
        return (base * 0.75 + 1.5 + 3.25 * k).to(dt)
    return (base * 3 + 1 + 5 * k).to(dt)


def _trace(merge_leaves, specs):
    from torch.fx.experimental.proxy_tensor import make_fx
    from dpark_tpu_torch.backend.cuda.fuse import python_float_semantics
    nl = len(specs)

    def flat(*xs):
        return tuple(merge_leaves(list(xs[:nl]), list(xs[nl:])))
    ex = [_example(dt, shp, k)
          for k, (dt, shp) in enumerate(list(specs) + list(specs))]
    with python_float_semantics():
        gm = make_fx(flat)(*ex)
    gm.graph.eliminate_dead_code()
    return gm


class _Lowering:
    def __init__(self, gm, specs):
        self.gm = gm
        self.specs = specs
        self.nslots = sum(int(np.prod(s, dtype=int)) for _, s in specs)
        if self.nslots > MAX_SLOTS:
            raise NotLowered("%d slots (the program holds %d)"
                             % (self.nslots, MAX_SLOTS))
        self.b = _Emitter(self.nslots)
        self.env = {}

    # graph values: ("r", an object array of registers, the traced shape
    # with the batch dimension cut to 1), ("c", a real constant tensor),
    # ("n", a Python number), ("l", a list of values) or ("o", any other
    # argument)
    def _regs(self, v):
        """An operand as a register array (constants become registers)."""
        kind, x = v
        if kind == "r":
            return x
        if kind == "n":
            return np.array(self.b.const(_number(x)), dtype=object)
        if kind != "c":
            raise NotLowered("an operand of kind %s" % kind)
        arr = np.empty(tuple(x.shape), dtype=object)
        for idx in np.ndindex(*x.shape):
            arr[idx] = self.b.const(x[idx])
        return arr

    def _meta_shape(self, node):
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise NotLowered("%s gives no tensor" % node.target)
        shape = tuple(val.shape)
        if not shape or shape[0] != TRACE_ROWS:
            raise NotLowered("%s moves the batch dimension" % node.target)
        return (1,) + shape[1:], val.dtype

    def _value(self, a):
        if hasattr(a, "op"):
            return self.env[a]
        if isinstance(a, (bool, int, float)):
            return ("n", a)
        if isinstance(a, (list, tuple)):
            return ("l", [self._value(x) for x in a])
        return ("o", a)

    def run(self):
        S = self.nslots
        ph = [n for n in self.gm.graph.nodes if n.op == "placeholder"]
        reg = 0
        slot_regs = []
        for _ in range(2):              # a's leaves, then b's
            for dt, shp in self.specs:
                w = int(np.prod(shp, dtype=int))
                regs = np.empty(w, dtype=object)
                for k in range(w):
                    regs[k] = reg
                    self.b.dt.append(CODE[dt])
                    reg += 1
                slot_regs.append(regs.reshape((1,) + tuple(shp)))
        assert reg == 2 * S and len(ph) == len(slot_regs)
        for n, regs in zip(ph, slot_regs):
            self.env[n] = ("r", regs)
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                continue
            if node.op == "get_attr":
                self.env[node] = ("c", getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.env[node] = self._call(node)
            elif node.op == "output":
                out = node.args[0]
            else:
                raise NotLowered("graph node %s" % node.op)
        return self._outputs(out)

    def _outputs(self, out):
        if not isinstance(out, (list, tuple)) or len(out) != len(self.specs):
            raise NotLowered("the merge returns %s leaves, not %d" % (
                len(out) if isinstance(out, (list, tuple)) else "no",
                len(self.specs)))
        regs = []
        for o, (dt, shp) in zip(out, self.specs):
            arr = self._regs(self._value(o))
            try:
                arr = np.broadcast_to(arr, (1,) + tuple(shp))
            except ValueError:
                raise NotLowered("a merged leaf of shape %s, not %s" % (
                    arr.shape[1:], tuple(shp)))
            regs.extend(self.b.cast(r, CODE[dt]) for r in arr.reshape(-1))
        code, consts, outregs, nregs = self.b.allocate(regs)
        if len(code) > MAX_INSTRS:
            raise NotLowered("%d instructions (the program holds %d)"
                             % (len(code), MAX_INSTRS))
        if nregs > MAX_REGS:
            raise NotLowered("%d registers (the program holds %d)"
                             % (nregs, MAX_REGS))
        return Program(list(self.specs), code, consts, outregs, nregs)

    def _call(self, node):
        t = node.target
        args = [self._value(a) for a in node.args]
        kwargs = {k: self._value(v) for k, v in node.kwargs.items()}
        if not any(_has_regs(v) for v in args + list(kwargs.values())):
            return self._fold(node)
        if t in _ELEMENTWISE:
            return self._elementwise(node, args, kwargs)
        if t in _IDENTITY:
            return args[0]
        if t is torch.ops.aten._to_copy.default:
            return self._cast(node, args)
        return self._rearrange(node, args)

    def _fold(self, node):
        """Run a node of constants only (torch's own semantics); an
        expand of a constant over the batch becomes registers."""
        from dpark_tpu_torch.backend.cuda.fuse import python_float_semantics

        def real(a):
            if hasattr(a, "op"):
                kind, x = self.env[a]
                return x
            if isinstance(a, (list, tuple)):
                return type(a)(real(x) for x in a)
            return a
        with python_float_semantics():
            val = node.target(*real(node.args), **{
                k: real(v) for k, v in node.kwargs.items()})
        if not isinstance(val, torch.Tensor):
            raise NotLowered("%s gives no tensor" % node.target)
        if val.dim() and val.shape[0] == TRACE_ROWS:
            if not bool((val == val[:1]).all()) and not bool(
                    val.isnan().all()):
                raise NotLowered("a constant varies over the batch")
            return ("r", self._regs(("c", val[:1])))
        return ("c", val)

    def _elementwise(self, node, args, kwargs):
        op, arity = _ELEMENTWISE[node.target]
        shape, out_dt = self._meta_shape(node)
        if len(args) != arity or kwargs.get("alpha", ("n", 1)) != ("n", 1):
            raise NotLowered("%s with %d operands or an alpha"
                             % (node.target, len(args)))
        if op == "rsub":
            op, args = SUB, [args[1], args[0]]
        elif op == "div_mode":
            mode = kwargs.get("rounding_mode", ("o", None))[1]
            if mode == "floor":
                op = FLOORDIV
            elif mode is None:
                op = DIV
            else:
                raise NotLowered("division with rounding %r" % (mode,))
        out_code = CODE.get(out_dt)
        if out_code is None:
            raise NotLowered("%s gives %s" % (node.target, out_dt))
        if op in COMPARE:
            code = CODE[torch.result_type(*[self._standin(a, v) for a, v
                                             in zip(node.args, args)])]
        elif op in LOGICAL:
            code = BOOL
        else:
            code = out_code
        if code == BOOL and op in (SUB, DIV, FLOORDIV, REM, NEG, ABS):
            raise NotLowered("%s on bool" % OP_NAMES[op])
        if code in (F64, F32) and op in (BAND, BOR, BXOR, BNOT):
            raise NotLowered("%s on float" % OP_NAMES[op])
        try:
            arrs = [np.broadcast_to(a, shape) for a in np.broadcast_arrays(
                *[self._regs(v) for v in args])]
        except ValueError:
            raise NotLowered("%s: operands do not broadcast to %s"
                             % (node.target, shape))
        res = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            regs = [a[idx] for a in arrs]
            if op == WHERE:
                c = self.b.cast(regs[0], BOOL)
                x, y = (self.b.cast(r, code) for r in regs[1:])
                res[idx] = self.b.emit(WHERE, code, out_code, c, x, y)
            else:
                rs = [self.b.cast(r, code) for r in regs]
                res[idx] = self.b.emit(op, code, out_code, rs[0],
                                       rs[1] if len(rs) > 1 else None)
        return ("r", res)

    @staticmethod
    def _standin(a, v):
        """What torch.result_type reads of an operand: its traced value,
        a constant, or a Python number."""
        return a.meta["val"] if v[0] == "r" else v[1]

    def _cast(self, node, args):
        _, dt = self._meta_shape(node)
        if dt not in CODE:
            raise NotLowered("cast to %s" % dt)
        arr = self._regs(args[0])
        res = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(*arr.shape):
            res[idx] = self.b.cast(arr[idx], CODE[dt])
        return ("r", res)

    def _rearrange(self, node, args):
        t = node.target
        aten = torch.ops.aten
        if t in _RESHAPES:
            shape, _ = self._meta_shape(node)
            return ("r", self._regs(args[0]).reshape(shape))
        if t is aten.expand.default:
            shape, _ = self._meta_shape(node)
            return ("r", np.broadcast_to(self._regs(args[0]), shape))
        if t is aten.select.int:
            arr = self._regs(args[0])
            dim = _dim(args[1][1], arr.ndim)
            return ("r", np.take(arr, args[2][1], axis=dim))
        if any(v[0] == "r" and v[1].size > 1 for v in args):
            raise NotLowered("the lanes of a vector leaf mix through %s "
                             "(outside the op set)" % t)
        raise NotLowered("op outside the set: %s" % t)


def _dim(d, ndim):
    d = d + ndim if d < 0 else d
    if d == 0:
        raise NotLowered("an op over the batch dimension")
    return d


def _number(x):
    """A Python number as the 0-dim tensor aten wraps it in."""
    if isinstance(x, bool):
        return torch.tensor(x, dtype=torch.bool)
    if isinstance(x, int):
        return torch.tensor(x, dtype=torch.int64)
    return torch.tensor(x, dtype=torch.float64)


def _has_regs(v):
    kind, x = v
    if kind == "r":
        return True
    if kind == "l":
        return any(_has_regs(y) for y in x)
    return False


def lower(merge_leaves, specs):
    """(Program, None), or (None, the reason the merge is not lowered).
    specs: [(torch dtype, lane shape)] per value leaf."""
    specs = [(dt, tuple(shp)) for dt, shp in specs]
    if not specs:
        return None, "a merge of no leaves"
    bad = [dt for dt, _ in specs if dt not in CODE]
    if bad:
        return None, "leaf dtype %s" % bad[0]
    try:
        gm = _trace(merge_leaves, specs)
    except Exception as e:      # user code: any failure means "no program"
        return None, "does not trace (%s: %s)" % (type(e).__name__,
                                                   str(e)[:160])
    try:
        return _Lowering(gm, specs).run(), None
    except NotLowered as e:
        return None, str(e)


def signature(leaves):
    """The lowering key of (N, cap, ...) value leaves."""
    return tuple((v.dtype, tuple(v.shape[2:])) for v in leaves)


def program_for(merge_leaves, sig):
    """The Program of `merge_leaves` at a leaf signature, lowered once and
    memoised on the function (`programs`: signature -> (Program, reason));
    the first lowering sets `route` (K14_SEPARABLE for a lane-separable
    program, K14 for another, or the reason)."""
    if inspect.ismethod(merge_leaves) or not isinstance(
            getattr(merge_leaves, "__dict__", None), dict):
        raise TypeError("%r holds no programs: wrap it with "
                        "merge_program.lowerable" % (merge_leaves,))
    memo = merge_leaves.__dict__.setdefault("programs", {})
    if sig not in memo:
        memo[sig] = lower(merge_leaves, sig)
        if getattr(merge_leaves, "route", None) is None:
            prog, reason = memo[sig]
            merge_leaves.route = (
                reason if prog is None else K14 if prog.separable_ops()
                is None else K14_SEPARABLE)
    return memo[sig][0]


def lowerable(fn):
    """fn (a bound method, which holds no attributes) as a function that
    memoises its programs."""
    def merge(va, vb):
        return fn(va, vb)
    merge.route = None
    return merge
