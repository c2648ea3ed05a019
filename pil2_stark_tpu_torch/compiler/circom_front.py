"""A circom front-end (parser + elaborator + witness calculator + R1CS
builder) for the Goldilocks verifier-circuit dialect.

The reference relies on the external `circom` compiler plus
`circom_runtime` WASM witness calculation to close the recursion chain
(SURVEY.md §3.4).  Neither is a dependency of this project, so this module
implements the needed subset of the language natively: the circuits our
`compiler.pil2circom` generator emits (and the reference's own
`circuits.gl` gadget set, which doubles as a conformance fixture for
tests) elaborate to

  - a witness vector (signal values, index 0 = the constant one),
  - an R1CS constraint list (A·B + C = 0 rows of linear combinations),
  - custom-gate declarations + uses (template name, parameters, flattened
    signal list in declaration order) — the exact shape
    compressor12_setup.js consumes (customGatesInfo / customGatesUses),
  - the nPubInputs/nOutputs header fields, with public signals remapped
    to witness indices 1..nPublics as circom does.

Language subset: templates (plain / custom / parallel), functions, var &
signal declarations with multi-dim arrays, components (named, arrays,
anonymous calls, tuple destructuring), for/while/if/assert, `<==`, `<--`,
`==>`, `===`, `_` discards, signal tags (parsed, ignored), ternaries, and
the full operator set over F_p with circom semantics (`\\` int division,
`/` field division, shifts/bitops on canonical representatives).
"""
from __future__ import annotations

import contextlib
import re

from ..field import gl64

# Active circuit field.  The GL tier compiles over the Goldilocks prime
# (circom -p goldilocks); the BN128 recursion tier over the BN254 scalar
# field — swapped for the duration of a compile via `field_prime`.
P = gl64.P_INT

BN254_FR = (
    21888242871839275222246405745257275088548364400416034343698204186575808495617
)


@contextlib.contextmanager
def field_prime(p: int):
    """Run a compile+witness under a different circuit prime (process-wide,
    like circom's -p flag; compiles are synchronous so this nests safely)."""
    global P
    old = P
    P = p
    try:
        yield
    finally:
        P = old


# ---------------------------------------------------------------------------
# lexer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>0x[0-9a-fA-F]+|\d+)
  | (?P<id>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op><==|==>|<--|-->|===|\*\*|<<|>>|<=|>=|==|!=|&&|\|\||[-+*/\\%&|^!<>=(){}\[\],;.?:_])
    """,
    re.VERBOSE | re.DOTALL,
)


def tokenize(src: str):
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"circom lex error at {src[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


# ---------------------------------------------------------------------------
# parser — produces a light AST of tuples


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"expected {val!r}, got {t[1]!r} (#{self.i})")
        return t

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # ---- top level

    def parse_file(self):
        items = {"includes": [], "templates": {}, "functions": {}, "main": None}
        while self.peek()[0] != "eof":
            t = self.peek()[1]
            if t == "pragma":
                while self.next()[1] != ";":
                    pass
            elif t == "include":
                self.next()
                name = self.next()[1]
                # the string literal comes through the lexer as id/op bits —
                # includes are written as include "file.circom";
                raise SyntaxError("include must be pre-stripped")
            elif t == "template":
                self.next()
                custom = parallel = False
                while self.peek()[1] in ("custom", "parallel"):
                    if self.next()[1] == "custom":
                        custom = True
                    else:
                        parallel = True
                name = self.next()[1]
                self.expect("(")
                params = []
                if self.peek()[1] != ")":
                    params.append(self.next()[1])
                    while self.accept(","):
                        params.append(self.next()[1])
                self.expect(")")
                body = self.parse_block()
                items["templates"][name] = {
                    "params": params,
                    "body": body,
                    "custom": custom,
                }
            elif t == "function":
                self.next()
                name = self.next()[1]
                self.expect("(")
                params = []
                if self.peek()[1] != ")":
                    params.append(self.next()[1])
                    while self.accept(","):
                        params.append(self.next()[1])
                self.expect(")")
                body = self.parse_block()
                items["functions"][name] = {"params": params, "body": body}
            elif t == "component":
                # component main {public [a,b]} = Tmpl();
                self.next()
                assert self.next()[1] == "main"
                publics = []
                if self.accept("{"):
                    self.expect("public")
                    self.expect("[")
                    publics.append(self.next()[1])
                    while self.accept(","):
                        publics.append(self.next()[1])
                    self.expect("]")
                    self.expect("}")
                self.expect("=")
                call = self.parse_expr()
                self.expect(";")
                items["main"] = {"publics": publics, "call": call}
            else:
                raise SyntaxError(f"unexpected top-level token {t!r}")
        return items

    # ---- statements

    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek()[1] != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return stmts

    def parse_stmt(self):
        t = self.peek()[1]
        if t == "{":
            return ("block", self.parse_block())
        if t == "var":
            self.next()
            return self.parse_decl("var")
        if t == "signal":
            self.next()
            kind = "signal"
            if self.peek()[1] in ("input", "output"):
                kind = "signal_" + self.next()[1]
            if self.peek()[1] == "{":  # tag
                while self.next()[1] != "}":
                    pass
            return self.parse_decl(kind)
        if t == "component":
            self.next()
            return self.parse_decl("component")
        if t == "for":
            self.next()
            self.expect("(")
            init = self.parse_stmt()  # handles `var i = 0;` and `i = 0;`
            cond = self.parse_expr()
            self.expect(";")
            step = self.parse_step()
            self.expect(")")
            body = (
                ("block", self.parse_block())
                if self.peek()[1] == "{"
                else self.parse_stmt()
            )
            return ("for", init, cond, step, body)
        if t == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = (
                ("block", self.parse_block())
                if self.peek()[1] == "{"
                else self.parse_stmt()
            )
            return ("while", cond, body)
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = (
                ("block", self.parse_block())
                if self.peek()[1] == "{"
                else self.parse_stmt()
            )
            els = None
            if self.accept("else"):
                els = (
                    ("block", self.parse_block())
                    if self.peek()[1] == "{"
                    else self.parse_stmt()
                )
            return ("if", cond, then, els)
        if t == "assert":
            self.next()
            self.expect("(")
            e = self.parse_expr()
            self.expect(")")
            self.expect(";")
            return ("assert", e)
        if t == "return":
            self.next()
            e = self.parse_expr()
            self.expect(";")
            return ("return", e)
        if t == "(":
            # tuple destructuring: (a, b, c) <== Call()(...)
            self.next()
            targets = [self.parse_expr()]
            while self.accept(","):
                targets.append(self.parse_expr())
            self.expect(")")
            op = self.next()[1]
            assert op in ("<==", "<--", "="), op
            rhs = self.parse_expr()
            self.expect(";")
            return ("tuple_assign", targets, op, rhs)
        s = self.parse_simple_stmt()
        return s

    def parse_decl(self, kind):
        entries = []
        while True:
            name = self.next()[1]
            dims = []
            while self.accept("["):
                dims.append(self.parse_expr())
                self.expect("]")
            init = None
            init_op = None
            if self.peek()[1] in ("=", "<==", "<--"):
                init_op = self.next()[1]
                init = self.parse_expr()
            entries.append((name, dims, init_op, init))
            if not self.accept(","):
                break
        self.expect(";")
        return ("decl", kind, entries)

    def parse_step(self):
        # i++ / i-- / i = e / i += e
        lhs = self.parse_expr()
        t = self.peek()[1]
        if t == "=":
            self.next()
            rhs = self.parse_expr()
            return ("assign", lhs, "=", rhs)
        if t in ("+", "-", "*") and self.peek(1)[1] == "=":
            op = self.next()[1]
            self.next()
            rhs = self.parse_expr()
            return ("assign", lhs, op + "=", rhs)
        if t in ("+", "-") and self.peek(1)[1] == t:
            self.next()
            self.next()
            return ("assign", lhs, "+=" if t == "+" else "-=", ("num", 1))
        return ("expr", lhs)

    def parse_simple_stmt(self):
        # assignment / constraint / expression statement, ending with ;
        lhs = self.parse_expr()
        t = self.peek()[1]
        if t in ("<==", "<--", "==>", "-->", "===", "="):
            self.next()
            # compound ops like += are lexed as '+' '='? no — handle x += y:
            rhs = self.parse_expr()
            self.expect(";")
            return ("assign", lhs, t, rhs)
        if t in ("+", "-", "*") and self.peek(1)[1] == "=":
            op = self.next()[1]
            self.next()
            rhs = self.parse_expr()
            self.expect(";")
            return ("assign", lhs, op + "=", rhs)
        if t == "+" and self.peek(1)[1] == "+":
            self.next()
            self.next()
            self.expect(";")
            return ("assign", lhs, "+=", ("num", 1))
        if t == "-" and self.peek(1)[1] == "-":
            self.next()
            self.next()
            self.expect(";")
            return ("assign", lhs, "-=", ("num", 1))
        self.expect(";")
        return ("expr", lhs)

    # ---- expressions (precedence climbing)

    _BINOPS = [
        ("||",),
        ("&&",),
        ("|",),
        ("^",),
        ("&",),
        ("==", "!="),
        ("<", ">", "<=", ">="),
        ("<<", ">>"),
        ("+", "-"),
        ("*", "/", "\\", "%"),
    ]

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        cond = self.parse_binary(0)
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("ternary", cond, a, b)
        return cond

    def parse_binary(self, level):
        if level == len(self._BINOPS):
            return self.parse_pow()
        lhs = self.parse_binary(level + 1)
        ops = self._BINOPS[level]
        while self.peek()[1] in ops:
            # don't swallow the '=' of compound assignment or statements:
            # handled because '=' is not in ops
            if self.peek()[1] in ("+", "-", "*") and self.peek(1)[1] == "=":
                break
            if self.peek()[1] in ("+", "-") and self.peek(1)[1] == self.peek()[1]:
                break  # ++ / --
            op = self.next()[1]
            rhs = self.parse_binary(level + 1)
            lhs = ("bin", op, lhs, rhs)
        return lhs

    def parse_pow(self):
        base = self.parse_unary()
        if self.peek()[1] == "**":
            self.next()
            exp = self.parse_pow()
            return ("bin", "**", base, exp)
        return base

    def parse_unary(self):
        t = self.peek()[1]
        if t == "-":
            self.next()
            return ("neg", self.parse_unary())
        if t == "!":
            self.next()
            return ("not", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_atom()
        while True:
            t = self.peek()[1]
            if t == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif t == ".":
                self.next()
                name = self.next()[1]
                e = ("member", e, name)
            elif t == "(":
                self.next()
                args = []
                if self.peek()[1] != ")":
                    args.append(self.parse_expr())
                    while self.accept(","):
                        args.append(self.parse_expr())
                self.expect(")")
                e = ("call", e, args)
            else:
                return e

    def parse_atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("num", int(val, 0))
        if val == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if val == "[":
            items = []
            if self.peek()[1] != "]":
                items.append(self.parse_expr())
                while self.accept(","):
                    items.append(self.parse_expr())
            self.expect("]")
            return ("array", items)
        if kind == "id" or val == "_":
            return ("id", val)
        raise SyntaxError(f"unexpected token {val!r} in expression")


_INCLUDE_RE = re.compile(r'^\s*include\s+"([^"]+)"\s*;\s*$', re.M)


def parse_sources(files: dict, entry: str):
    """Resolve includes (by filename, any directory prefix stripped) and
    parse every reachable file into one merged item table."""
    merged = {"templates": {}, "functions": {}, "main": None}
    seen = set()

    def load(name):
        base = name.split("/")[-1]
        if base in seen:
            return
        seen.add(base)
        src = files[base]
        for inc in _INCLUDE_RE.findall(src):
            load(inc)
        src = _INCLUDE_RE.sub("", src)
        items = Parser(tokenize(src)).parse_file()
        merged["templates"].update(items["templates"])
        merged["functions"].update(items["functions"])
        if items["main"]:
            merged["main"] = items["main"]

    load(entry)
    return merged


# ---------------------------------------------------------------------------
# values: numeric + symbolic (linear combination / quadratic / poisoned)


class LC:
    """Linear combination {signal: coeff} + const, mod p."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=0):
        self.terms = terms or {}
        self.const = const % P

    @staticmethod
    def of_const(c):
        return LC({}, c)

    @staticmethod
    def of_signal(s):
        return LC({s: 1}, 0)

    def is_const(self):
        return not self.terms

    def add(self, o):
        t = dict(self.terms)
        for s, c in o.terms.items():
            t[s] = (t.get(s, 0) + c) % P
            if t[s] == 0:
                del t[s]
        return LC(t, self.const + o.const)

    def scale(self, k):
        k %= P
        if k == 0:
            return LC({}, 0)
        return LC({s: (c * k) % P for s, c in self.terms.items()}, self.const * k)

    def neg(self):
        return self.scale(P - 1)


class Quad:
    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a, self.b, self.c = a, b, c


POISON = object()  # symbolic value beyond quadratic (fine under <--)


class Value:
    __slots__ = ("num", "sym")

    def __init__(self, num, sym):
        self.num = num % P
        self.sym = sym

    @staticmethod
    def const(n):
        n %= P
        return Value(n, LC.of_const(n))


def _v_neg(a):
    num = (P - a.num) % P
    if a.sym is POISON:
        return Value(num, POISON)
    if isinstance(a.sym, Quad):
        # -(A·B + C) = (-A)·B + (-C)
        return Value(num, Quad(a.sym.a.neg(), a.sym.b, a.sym.c.neg()))
    return Value(num, a.sym.neg())


def _v_add(a, b):
    num = (a.num + b.num) % P
    sa, sb = a.sym, b.sym
    if sa is POISON or sb is POISON:
        return Value(num, POISON)
    if isinstance(sa, LC) and isinstance(sb, LC):
        return Value(num, sa.add(sb))
    if isinstance(sa, Quad) and isinstance(sb, LC):
        return Value(num, Quad(sa.a, sa.b, sa.c.add(sb)))
    if isinstance(sa, LC) and isinstance(sb, Quad):
        return Value(num, Quad(sb.a, sb.b, sb.c.add(sa)))
    return Value(num, POISON)


def _v_sub(a, b):
    return _v_add(a, _v_neg(b))


def _v_mul(a, b):
    num = (a.num * b.num) % P
    if a.sym is POISON or b.sym is POISON:
        return Value(num, POISON)
    sa, sb = a.sym, b.sym
    if isinstance(sa, LC) and sa.is_const():
        if isinstance(sb, LC):
            return Value(num, sb.scale(sa.const))
        return Value(num, Quad(sb.a.scale(sa.const), sb.b, sb.c.scale(sa.const)))
    if isinstance(sb, LC) and sb.is_const():
        if isinstance(sa, LC):
            return Value(num, sa.scale(sb.const))
        return Value(num, Quad(sa.a.scale(sb.const), sa.b, sa.c.scale(sb.const)))
    if isinstance(sa, LC) and isinstance(sb, LC):
        return Value(num, Quad(sa, sb, LC.of_const(0)))
    return Value(num, POISON)


# ---------------------------------------------------------------------------
# elaborator


class Signal:
    __slots__ = ("idx", "assigned")

    def __init__(self, idx):
        self.idx = idx
        self.assigned = False


class Component:
    def __init__(self, tname, tdef, params, interp):
        self.tname = tname
        self.tdef = tdef
        self.params = params
        self.scope = {}
        self.inputs_needed = 0
        self.inputs_seen = 0
        self.ran = False
        self.interp = interp
        interp.all_components.append(self)
        self.in_order = []  # input signal names in declaration order
        self.out_order = []
        self.decl_order = []  # all signal names in declaration order
        # Pre-scan: declare input/output signals so the parent can wire
        # them before the body runs.
        interp._declare_io(self)

    def signals_flat(self, names):
        out = []
        for n in names:
            out.extend(_flatten_sig(self.scope[n]))
        return out


def _flatten_sig(v):
    if isinstance(v, Signal):
        return [v]
    out = []
    for x in v:
        out.extend(_flatten_sig(x))
    return out


def _make_sig_array(dims, alloc):
    if not dims:
        return alloc()
    return [_make_sig_array(dims[1:], alloc) for _ in range(dims[0])]


class ReturnExc(Exception):
    def __init__(self, value):
        self.value = value


class Interp:
    def __init__(self, items):
        self.items = items
        self.n_signals = 1  # index 0 = constant one
        self.witness = {0: 1}
        self.constraints = []  # (A, B, C) LCs:  A·B + C = 0
        self.custom_gates = []  # {"template", "parameters"}
        self.custom_uses = []  # {"id", "signals"}
        self.main = None
        self.signal_order = []  # allocation order (for remapping)
        self._fn_cache = {}  # (name, const args) -> result (functions are pure)
        self.all_components = []  # every instantiation, for the final sweep

    # ---- signal allocation

    def new_signal(self):
        s = Signal(self.n_signals)
        self.n_signals += 1
        return s

    # ---- template IO pre-scan (declaration order of inputs/outputs)

    def _declare_io(self, comp):
        """Prologue pre-scan: execute `var` decls (compile-time values like
        log2(n) that size the IO arrays) and allocate input/output signal
        arrays, so the parent can wire inputs before the body runs.
        Internal signal/component decls and all other statements are
        skipped here and handled by the body run.  The scan walks the
        WHOLE body: circom allows IO declarations after logic (the
        reference's stark_verifier.circom.ejs declares the inputChallenges
        signals mid-template, :811-828), and circom requires IO array
        dims to be compile-time constants, so every IO decl is resolvable
        from params + previously scanned vars."""
        env = {
            p: Value.const(v) for p, v in zip(comp.tdef["params"], comp.params)
        }
        scope = comp.scope
        for st in comp.tdef["body"]:
            if st[0] == "assert":
                # compile-time shape asserts may precede IO decls; checked
                # again (with signals and loop-mutated vars) when the body
                # runs, so scan-time failures (incl. stale-env asserts
                # after skipped loops) are ignored here
                try:
                    self.exec_stmt(st, env, None)
                except (NameError, ValueError, AssertionError):
                    pass
                continue
            if st[0] != "decl":
                continue
            kind = st[1]
            if kind == "var":
                try:
                    for (name, dim_exprs, init_op, init) in st[2]:
                        dims = [
                            self._const_int(self.eval_expr(e, env, None))
                            for e in dim_exprs
                        ]
                        env[name] = _make_var_array(dims)
                        if init is not None:
                            env[name] = _copy_val(self.eval_expr(init, env, None))
                except (NameError, ValueError, AssertionError,
                        ZeroDivisionError):
                    # a var that references signals or loop-mutated state
                    # the scan does not track (stale values can trip
                    # function asserts/inverses) — unusable for IO dims;
                    # any later IO decl that needs it fails loudly below,
                    # and the body run re-evaluates it with live values
                    continue
                continue
            if kind not in ("signal_input", "signal_output"):
                continue
            for (name, dim_exprs, init_op, init) in st[2]:
                dims = [
                    self._const_int(self.eval_expr(e, env, None)) for e in dim_exprs
                ]
                arr = _make_sig_array(dims, self.new_signal)
                scope[name] = arr
                comp.decl_order.append(name)
                if kind == "signal_input":
                    comp.in_order.append(name)
                    comp.inputs_needed += len(_flatten_sig(arr))
                else:
                    comp.out_order.append(name)
        comp.io_env = {
            p: Value.const(v) for p, v in zip(comp.tdef["params"], comp.params)
        }

    def _const_int(self, v):
        if isinstance(v, Value):
            if not (isinstance(v.sym, LC) and v.sym.is_const()):
                raise ValueError("expected compile-time constant")
            return v.num
        return int(v)

    # ---- main entry

    def run_main(self, input_values: dict):
        main = self.items["main"]
        call = main["call"]
        assert call[0] == "call"
        tname = call[1][1]
        params = [
            self._const_int(self.eval_expr(a, {}, None)) for a in call[2]
        ]
        tdef = self.items["templates"][tname]
        comp = Component(tname, tdef, params, self)
        self.main = comp

        # wire inputs from the provided dict
        for name in comp.in_order:
            if name not in input_values:
                raise KeyError(f"missing main input {name}")
            self._assign_input(comp.scope[name], input_values[name])
        self.run_body(comp)

        # Elaborate any named component whose outputs were never read
        # (e.g. a check-only sub-verifier with no output signals): circom
        # runs a component once all its inputs are assigned; skipping it
        # would silently drop every constraint it contributes.  Iterate to
        # a fixpoint — running one body can instantiate/wire others.
        while True:
            pending = [c for c in self.all_components if not c.ran]
            if not pending:
                break
            for compo in pending:
                flat = []
                for n in compo.in_order:
                    flat.extend(_flatten_sig(compo.scope[n]))
                if not all(s.assigned for s in flat):
                    raise RuntimeError(
                        f"component {compo.tname} instantiated but its "
                        f"inputs were never fully wired"
                    )
                self.run_body(compo)

        # remap publics to 1..nPub
        pub_names = main["publics"]
        pub_sigs = []
        for n in pub_names:
            if n in comp.out_order:
                continue
            pub_sigs.extend(s.idx for s in _flatten_sig(comp.scope[n]))
        out_sigs = []
        for n in comp.out_order:
            out_sigs.extend(s.idx for s in _flatten_sig(comp.scope[n]))
        self._remap(out_sigs, pub_sigs)
        self.n_outputs = len(out_sigs)
        self.n_pub_inputs = len(pub_sigs)
        return self

    def _assign_input(self, sig_arr, values):
        if isinstance(sig_arr, Signal):
            v = int(values) % P
            self.witness[sig_arr.idx] = v
            sig_arr.assigned = True
            return
        assert len(sig_arr) == len(values), "input shape mismatch"
        for s, v in zip(sig_arr, values):
            self._assign_input(s, v)

    def _remap(self, out_sigs, pub_sigs):
        perm = {0: 0}
        nxt = 1
        for s in out_sigs + pub_sigs:
            perm[s] = nxt
            nxt += 1
        for s in range(1, self.n_signals):
            if s not in perm:
                perm[s] = nxt
                nxt += 1
        self.witness = {perm[s]: v for s, v in self.witness.items()}
        def remap_lc(lc):
            return LC({perm[s]: c for s, c in lc.terms.items()}, lc.const)
        self.constraints = [
            (remap_lc(a), remap_lc(b), remap_lc(c)) for a, b, c in self.constraints
        ]
        for u in self.custom_uses:
            u["signals"] = [perm[s] for s in u["signals"]]

    # ---- component body execution

    def run_body(self, comp):
        if comp.ran:
            return
        comp.ran = True
        env = dict(comp.io_env)
        try:
            for st in comp.tdef["body"]:
                self.exec_stmt(st, env, comp)
        except ReturnExc:
            raise RuntimeError("return outside function")
        if comp.tdef.get("custom"):
            # record the gate use: parameters + flattened IO signals in
            # declaration order (the .r1cs customGates shape)
            key = (comp.tname, tuple(comp.params))
            for gid, g in enumerate(self.custom_gates):
                if (g["template"], tuple(g["parameters"])) == key:
                    break
            else:
                gid = len(self.custom_gates)
                self.custom_gates.append(
                    {"template": comp.tname, "parameters": list(comp.params)}
                )
            sigs = [s.idx for s in comp.signals_flat(comp.decl_order)]
            self.custom_uses.append({"id": gid, "signals": sigs})

    # ---- statements

    def exec_stmt(self, st, env, comp):
        kind = st[0]
        if kind == "block":
            for s in st[1]:
                self.exec_stmt(s, env, comp)
        elif kind == "decl":
            self.exec_decl(st, env, comp)
        elif kind == "assign":
            self.exec_assign(st[1], st[2], st[3], env, comp)
        elif kind == "tuple_assign":
            self.exec_tuple_assign(st[1], st[2], st[3], env, comp)
        elif kind == "for":
            self.exec_stmt(st[1], env, comp)
            while True:
                c = self.eval_expr(st[2], env, comp)
                if (c.num if isinstance(c, Value) else int(c)) == 0:
                    break
                self.exec_stmt(st[4], env, comp)
                self.exec_stmt(st[3], env, comp)
        elif kind == "while":
            while True:
                c = self.eval_expr(st[1], env, comp)
                if (c.num if isinstance(c, Value) else int(c)) == 0:
                    break
                self.exec_stmt(st[2], env, comp)
        elif kind == "if":
            c = self.eval_expr(st[1], env, comp)
            if (c.num if isinstance(c, Value) else int(c)) != 0:
                self.exec_stmt(st[2], env, comp)
            elif st[3] is not None:
                self.exec_stmt(st[3], env, comp)
        elif kind == "assert":
            c = self.eval_expr(st[1], env, comp)
            if (c.num if isinstance(c, Value) else int(c)) == 0:
                raise AssertionError("circom assert failed")
        elif kind == "expr":
            self.eval_expr(st[1], env, comp)
        elif kind == "return":
            raise ReturnExc(self.eval_expr(st[1], env, comp))
        else:
            raise ValueError(f"unknown stmt {kind}")

    def exec_decl(self, st, env, comp):
        kind = st[1]
        for (name, dim_exprs, init_op, init) in st[2]:
            dims = [
                self._const_int(self.eval_expr(e, env, comp)) for e in dim_exprs
            ]
            if kind == "var":
                env[name] = _make_var_array(dims)
                if init is not None:
                    env[name] = _copy_val(self.eval_expr(init, env, comp))
            elif kind in ("signal", "signal_input", "signal_output"):
                if kind != "signal" and name in comp.scope:
                    arr = comp.scope[name]  # pre-declared by _declare_io
                else:
                    arr = _make_sig_array(dims, self.new_signal)
                    comp.scope[name] = arr
                    comp.decl_order.append(name)
                env[name] = arr
                if init is not None:
                    rhs = self.eval_expr(init, env, comp)
                    self.assign_signal(arr, rhs, init_op, comp)
            elif kind == "component":
                env[name] = _make_none_array(dims) if dims else None
                if init is not None:
                    env[name] = self.eval_expr(init, env, comp)
            else:
                raise ValueError(kind)

    def exec_assign(self, lhs, op, rhs_expr, env, comp):
        if op in ("+=", "-=", "*="):
            cur = self.eval_expr(lhs, env, comp)
            rhs = self.eval_expr(rhs_expr, env, comp)
            cur_v = _as_value(cur, self)
            rhs_v = _as_value(rhs, self)
            if op == "+=":
                v = _v_add(cur_v, rhs_v)
            elif op == "-=":
                v = _v_sub(cur_v, rhs_v)
            else:
                v = _v_mul(cur_v, rhs_v)
            self.store_var(lhs, v, env, comp)
            return
        if op == "=":
            rhs = self.eval_expr(rhs_expr, env, comp)
            # value semantics for var arrays; Components pass by reference
            self.store_var(lhs, _copy_val(rhs), env, comp)
            return
        if op in ("==>", "-->"):
            lhs, rhs_expr = rhs_expr, lhs
            op = "<==" if op == "==>" else "<--"
            # fallthrough with swapped sides
            rhs = self.eval_expr(rhs_expr, env, comp)
            tgt = self.eval_lvalue_signal(lhs, env, comp)
            self.assign_signal(tgt, rhs, op, comp)
            return
        if op in ("<==", "<--"):
            if lhs == ("id", "_"):
                self.eval_expr(rhs_expr, env, comp)
                return
            rhs = self.eval_expr(rhs_expr, env, comp)
            tgt = self.eval_lvalue_signal(lhs, env, comp)
            self.assign_signal(tgt, rhs, op, comp)
            return
        if op == "===":
            a = self.eval_expr(lhs, env, comp)
            b = self.eval_expr(rhs_expr, env, comp)
            self.constrain_eq(a, b)
            return
        raise ValueError(op)

    def exec_tuple_assign(self, targets, op, rhs_expr, env, comp):
        rhs = self.eval_expr(rhs_expr, env, comp)
        assert isinstance(rhs, tuple), "tuple assign needs multi-output call"
        assert len(rhs) == len(targets)
        for tgt_expr, val in zip(targets, rhs):
            if tgt_expr == ("id", "_"):
                continue
            tgt = self.eval_lvalue_signal(tgt_expr, env, comp)
            self.assign_signal(tgt, val, op, comp)

    # ---- signal assignment & constraints

    def assign_signal(self, tgt, rhs, op, comp):
        """tgt: Signal or nested list; rhs: Value / list / Signal-array."""
        if isinstance(tgt, Signal):
            v = _as_value(rhs, self)
            if (
                op == "<=="
                and not tgt.assigned
                and isinstance(v.sym, LC)
                and len(v.sym.terms) == 1
                and v.sym.const == 0
                and next(iter(v.sym.terms.values())) == 1
            ):
                # pure copy: coalesce the wire instead of emitting a copy
                # constraint (circom's signal simplification)
                tgt.idx = next(iter(v.sym.terms))
                tgt.assigned = True
                return
            self.witness[tgt.idx] = v.num
            tgt.assigned = True
            if op == "<==":
                if comp is not None and comp.tdef.get("custom"):
                    return  # custom gates constrain via the PIL machine
                lc_t = LC.of_signal(tgt.idx)
                self._add_constraint(v, lc_t)
            return
        if isinstance(rhs, (list, tuple)):
            assert len(tgt) == len(rhs), "array assign shape mismatch"
            for t, r in zip(tgt, rhs):
                self.assign_signal(t, r, op, comp)
            return
        if isinstance(rhs, Signal):
            self.assign_signal(tgt, _as_value(rhs, self), op, comp)
            return
        raise ValueError("bad signal assignment")

    def _add_constraint(self, v, lc_target):
        """v == lc_target  as  A·B + C = 0."""
        if v.sym is POISON:
            raise ValueError("non-quadratic expression in <==/===")
        if isinstance(v.sym, LC):
            self.constraints.append(
                (LC.of_const(0), LC.of_const(0), v.sym.add(lc_target.neg()))
            )
        else:
            self.constraints.append(
                (v.sym.a, v.sym.b, v.sym.c.add(lc_target.neg()))
            )

    def constrain_eq(self, a, b):
        if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
            a_list = a if isinstance(a, (list, tuple)) else None
            b_list = b if isinstance(b, (list, tuple)) else None
            assert a_list is not None and b_list is not None
            assert len(a_list) == len(b_list)
            for x, y in zip(a_list, b_list):
                self.constrain_eq(x, y)
            return
        av = _as_value(a, self)
        bv = _as_value(b, self)
        if av.num != bv.num:
            raise AssertionError("=== failed numerically")
        diff = _v_sub(av, bv)
        if diff.sym is POISON:
            raise ValueError("non-quadratic ===")
        if isinstance(diff.sym, LC):
            self.constraints.append((LC.of_const(0), LC.of_const(0), diff.sym))
        else:
            self.constraints.append((diff.sym.a, diff.sym.b, diff.sym.c))

    # ---- lvalues

    def eval_lvalue_signal(self, e, env, comp):
        """Resolve an expression to a Signal / signal array target."""
        v = self.eval_expr(e, env, comp)
        return v

    def store_var(self, lhs, value, env, comp):
        if lhs[0] == "id":
            env[lhs[1]] = value
            return
        if lhs[0] == "index":
            container, idx_chain = self._resolve_container(lhs, env, comp)
            container[idx_chain] = value
            return
        raise ValueError("bad var lvalue")

    def _resolve_container(self, e, env, comp):
        idx = self._const_int(self.eval_expr(e[2], env, comp))
        base = e[1]
        if base[0] == "id":
            return env[base[1]], idx
        container, i2 = self._resolve_container(base, env, comp)
        return container[i2], idx

    # ---- expressions

    def eval_expr(self, e, env, comp):
        k = e[0]
        if k == "num":
            return Value.const(e[1])
        if k == "id":
            name = e[1]
            if name in env:
                return env[name]
            if comp is not None and name in comp.scope:
                return comp.scope[name]
            raise NameError(f"unknown identifier {name}")
        if k == "array":
            return [self.eval_expr(x, env, comp) for x in e[1]]
        if k == "neg":
            return _v_neg(_as_value(self.eval_expr(e[1], env, comp), self))
        if k == "not":
            v = _as_value(self.eval_expr(e[1], env, comp), self)
            return Value.const(0 if v.num else 1)
        if k == "ternary":
            c = _as_value(self.eval_expr(e[1], env, comp), self)
            return self.eval_expr(e[2] if c.num else e[3], env, comp)
        if k == "index":
            base = self.eval_expr(e[1], env, comp)
            idx = self._const_int(self.eval_expr(e[2], env, comp))
            return base[idx]
        if k == "member":
            compo = self.eval_expr(e[1], env, comp)
            assert isinstance(compo, Component), "member access on non-component"
            # reading an output triggers the body (inputs must be wired);
            # assigning inputs goes through the same path
            sig = compo.scope[e[2]]
            if e[2] in compo.out_order:
                self._maybe_run(compo)
            return sig
        if k == "call":
            return self.eval_call(e, env, comp)
        if k == "bin":
            return self.eval_bin(e, env, comp)
        raise ValueError(f"unknown expr {k}")

    def _maybe_run(self, compo):
        if compo.ran:
            return
        flat = []
        for n in compo.in_order:
            flat.extend(_flatten_sig(compo.scope[n]))
        if all(s.assigned for s in flat):
            self.run_body(compo)
        else:
            raise RuntimeError(
                f"outputs of {compo.tname} read before inputs wired"
            )

    def eval_call(self, e, env, comp):
        callee = e[1]
        args = e[2]
        # component instantiation or function call: Name(...)
        if callee[0] == "id":
            name = callee[1]
            if name in self.items["functions"]:
                f = self.items["functions"][name]
                vals = [self.eval_expr(a, env, comp) for a in args]
                key = None
                if all(isinstance(v, Value) and _is_const(v) for v in vals):
                    key = (name, tuple(v.num for v in vals))
                    if key in self._fn_cache:
                        return _copy_val(self._fn_cache[key])
                fenv = dict(zip(f["params"], (_copy_val(v) for v in vals)))
                try:
                    for st in f["body"]:
                        self.exec_stmt(st, fenv, comp)
                except ReturnExc as r:
                    if key is not None:
                        self._fn_cache[key] = _copy_val(r.value)
                    return r.value
                raise RuntimeError(f"function {name} did not return")
            if name in self.items["templates"]:
                params = [
                    self._const_int(self.eval_expr(a, env, comp)) for a in args
                ]
                return Component(name, self.items["templates"][name], params, self)
            raise NameError(f"unknown callable {name}")
        # anonymous component call: Component(inputs...)
        inner = self.eval_expr(callee, env, comp)
        assert isinstance(inner, Component), "call on non-component"
        vals = [self.eval_expr(a, env, comp) for a in args]
        assert len(vals) == len(inner.in_order), (
            f"{inner.tname}: {len(vals)} args for {len(inner.in_order)} inputs"
        )
        for n, v in zip(inner.in_order, vals):
            self.assign_signal(inner.scope[n], v, "<==", comp)
        self.run_body(inner)
        outs = tuple(inner.scope[n] for n in inner.out_order)
        if len(outs) == 1:
            return outs[0]
        return outs

    def eval_bin(self, e, env, comp):
        op = e[1]
        a = _as_value(self.eval_expr(e[2], env, comp), self)
        b = _as_value(self.eval_expr(e[3], env, comp), self)
        if op == "+":
            return _v_add(a, b)
        if op == "-":
            return _v_sub(a, b)
        if op == "*":
            return _v_mul(a, b)
        # the remaining operators are numeric-only: if either operand
        # carries signal structure the result is witness-only (POISON),
        # usable under <-- but rejected by <== / ===
        def _num_only(n):
            if _is_const(a) and _is_const(b):
                return Value.const(n)
            return Value(n, POISON)

        if op == "/":
            inv = pow(b.num, P - 2, P)
            if _is_const(b):
                return _v_mul(a, Value.const(inv))
            return Value((a.num * inv) % P, POISON)
        if op == "**":
            return _num_only(pow(a.num, b.num, P))
        if op == "\\":
            return _num_only(a.num // b.num)
        if op == "%":
            return _num_only(a.num % b.num)
        if op == "<<":
            return _num_only((a.num << b.num) % P)
        if op == ">>":
            return _num_only(a.num >> b.num)
        if op == "&":
            return _num_only(a.num & b.num)
        if op == "|":
            return _num_only(a.num | b.num)
        if op == "^":
            return _num_only(a.num ^ b.num)
        if op == "==":
            return _num_only(1 if a.num == b.num else 0)
        if op == "!=":
            return _num_only(1 if a.num != b.num else 0)
        # comparisons use the signed representative (circom semantics —
        # values above p/2 compare as negatives, so `i >= 0` terminates
        # decrementing loops)
        sa_n = a.num if a.num <= P // 2 else a.num - P
        sb_n = b.num if b.num <= P // 2 else b.num - P
        if op == "<":
            return _num_only(1 if sa_n < sb_n else 0)
        if op == ">":
            return _num_only(1 if sa_n > sb_n else 0)
        if op == "<=":
            return _num_only(1 if sa_n <= sb_n else 0)
        if op == ">=":
            return _num_only(1 if sa_n >= sb_n else 0)
        if op == "&&":
            return _num_only(1 if (a.num and b.num) else 0)
        if op == "||":
            return _num_only(1 if (a.num or b.num) else 0)
        raise ValueError(op)


def _is_const(v: "Value") -> bool:
    return isinstance(v.sym, LC) and v.sym.is_const()


def _make_var_array(dims):
    if not dims:
        return Value.const(0)
    return [_make_var_array(dims[1:]) for _ in range(dims[0])]


def _make_none_array(dims):
    if not dims:
        return None
    return [_make_none_array(dims[1:]) for _ in range(dims[0])]


def _copy_val(v):
    """circom var arrays have value semantics: deep-copy list structure
    (leaves — Values/Signals — are immutable or reference-shared wires)."""
    if isinstance(v, list):
        return [_copy_val(x) for x in v]
    return v


def _as_value(v, interp):
    if isinstance(v, Value):
        return v
    if isinstance(v, Signal):
        # unassigned signals read as 0 (circom semantics: unconstrained
        # wires default to zero — e.g. the zero-padded tail of a ≤4-wide
        # linear-hash output)
        return Value(interp.witness.get(v.idx, 0), LC.of_signal(v.idx))
    raise ValueError(f"expected scalar value, got {type(v)}")


# ---------------------------------------------------------------------------
# public API


class CompiledCircuit:
    """Result of compile+witness: R1CS-shaped data for the compressor and
    the full witness for exec."""

    def __init__(self, interp: Interp):
        self.prime = P
        self.n_vars = interp.n_signals
        self.n_outputs = interp.n_outputs
        self.n_pub_inputs = interp.n_pub_inputs
        self.constraints = [
            (
                {s: c for s, c in a.terms.items()} | ({0: a.const} if a.const else {}),
                {s: c for s, c in b.terms.items()} | ({0: b.const} if b.const else {}),
                {s: c for s, c in c_.terms.items()} | ({0: c_.const} if c_.const else {}),
            )
            for a, b, c_ in interp.constraints
        ]
        self.custom_gates = interp.custom_gates
        self.custom_uses = interp.custom_uses
        self.witness = [
            interp.witness.get(i, 0) for i in range(interp.n_signals)
        ]

    def check(self):
        """Verify every R1CS row against the witness."""
        w = self.witness
        q = self.prime
        for a, b, c in self.constraints:
            av = sum(w[s] * k for s, k in a.items()) % q
            bv = sum(w[s] * k for s, k in b.items()) % q
            cv = sum(w[s] * k for s, k in c.items()) % q
            if (av * bv + cv) % q != 0:
                return False
        return True


def compile_and_witness(files: dict, entry: str, inputs: dict, prime: int | None = None) -> CompiledCircuit:
    """Parse the circuit file set, elaborate `entry`'s main component with
    `inputs` (zkin-shaped dict of ints / nested lists), return the
    compiled circuit + witness.  `prime` selects the circuit field
    (default Goldilocks; pass circom_front.BN254_FR for the BN128 tier)."""
    with field_prime(prime or gl64.P_INT):
        items = parse_sources(files, entry)
        if items["main"] is None:
            raise ValueError("no main component")
        interp = Interp(items)
        interp.run_main(inputs)
        return CompiledCircuit(interp)
