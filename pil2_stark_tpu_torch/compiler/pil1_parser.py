"""PIL1 front-end: parses the Polynomial Identity Language (v1) into the
pilcom-compatible `pil` JSON structure consumed by the setup pipeline.

This is an original recursive-descent implementation of the PIL subset used
by the reference's state-machine fixtures (reference grammar: the external
`pilcom` dependency; fixture examples pil2-stark-js test/state_machines/).
Supported statements:

    constant %N = 2**6;
    include "other.pil";
    namespace Name(%N);
    pol constant A, B;          // fixed columns (arrays: A[4])
    pol commit a, b;            // witness columns
    pol name = <expr>;          // intermediate polynomial (imP)
    public out = pol(idx);      // public input binding
    <expr> = <expr>;            // polynomial identity
    [selF] {f...} in  [selT] {t...};   // plookup
    [selF] {f...} is  [selT] {t...};   // permutation
    {pols...} connect {consts...};     // copy-constraint / connection

Output shape (mirroring pilcom's pil.json): references, expressions (dict
AST nodes with leaf ops cm/const/public/number, binary add/sub/mul, unary
neg, rotation via `next`), polIdentities, plookupIdentities,
permutationIdentities, connectionIdentities, publics, nConstants,
nCommitments.
"""
from __future__ import annotations

import os
import re

TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<number>0x[0-9a-fA-F]+|\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<const>%[A-Za-z_][A-Za-z0-9_]*)
  | (?P<pub>:[A-Za-z_][A-Za-z0-9_]*)
  | (?P<pow>\*\*)
  | (?P<op>[{}()\[\],;=+\-*'.])
  | (?P<string>"[^"]*")
""",
    re.X | re.S,
)


class PilError(Exception):
    pass


def _tokenize(src: str):
    tokens = []
    pos = 0
    while pos < len(src):
        m = TOKEN_RE.match(src, pos)
        if not m:
            raise PilError(f"Unexpected character at {pos}: {src[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        tokens.append((m.lastgroup, m.group()))
    tokens.append(("eof", ""))
    return tokens


class Parser:
    """One Parser instance per top-level file; `include` recurses inline,
    sharing the mutable output dict + constants table."""

    KEYWORDS = {
        "constant", "include", "namespace", "pol", "commit", "public",
        "in", "is", "connect",
    }

    def __init__(self, out=None, consts=None, base_dir="."):
        self.out = out if out is not None else {
            "references": {},
            "expressions": [],
            "polIdentities": [],
            "plookupIdentities": [],
            "permutationIdentities": [],
            "connectionIdentities": [],
            "publics": [],
            "nConstants": 0,
            "nCommitments": 0,
            "nIm": 0,
        }
        self.consts = consts if consts is not None else {}
        self.base_dir = base_dir
        self.namespace = None
        self.pol_deg = None
        self.tokens = []
        self.i = 0

    # -- token helpers ------------------------------------------------------

    def peek(self, k=0):
        return self.tokens[min(self.i + k, len(self.tokens) - 1)]

    def next(self):
        t = self.tokens[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise PilError(f"Expected {val!r}, got {t[1]!r}")
        return t

    # -- entry --------------------------------------------------------------

    def parse_file(self, path: str):
        src = open(path).read()
        return self.parse_source(src, base_dir=os.path.dirname(path) or ".")

    def parse_source(self, src: str, base_dir=None):
        if base_dir is not None:
            self.base_dir = base_dir
        save = (self.tokens, self.i)
        self.tokens, self.i = _tokenize(src), 0
        while self.peek()[0] != "eof":
            self.parse_statement()
        self.tokens, self.i = save
        return self.out

    # -- statements ---------------------------------------------------------

    def parse_statement(self):
        kind, val = self.peek()
        if val == "constant":
            self.next()
            name = self.next()[1]
            if not name.startswith("%"):
                raise PilError("constant name must start with %")
            self.expect("=")
            self.consts[name] = self.parse_int_expr()
            self.expect(";")
        elif val == "include":
            self.next()
            fname = self.next()[1].strip('"')
            self.expect(";")
            sub = Parser(self.out, self.consts, self.base_dir)
            sub.parse_file(os.path.join(self.base_dir, fname))
        elif val == "namespace":
            self.next()
            name = self.next()[1]
            self.expect("(")
            deg = self.parse_int_expr()
            self.expect(")")
            self.expect(";")
            self.namespace = name
            self.pol_deg = deg
        elif val == "pol":
            self.parse_pol_decl()
        elif val == "public":
            self.parse_public()
        else:
            self.parse_identity_like()

    def parse_pol_decl(self):
        self.expect("pol")
        kind, val = self.peek()
        if val in ("constant", "commit"):
            self.next()
            ref_type = "constP" if val == "constant" else "cmP"
            while True:
                name = self.next()[1]
                length = None
                if self.peek()[1] == "[":
                    self.next()
                    length = self.parse_int_expr()
                    self.expect("]")
                self._add_reference(name, ref_type, length)
                if self.peek()[1] == ",":
                    self.next()
                    continue
                break
            self.expect(";")
        else:
            # intermediate: pol name = expr;
            name = self.next()[1]
            self.expect("=")
            e = self.parse_expr()
            self.expect(";")
            eid = len(self.out["expressions"])
            self.out["expressions"].append(e)
            full = f"{self.namespace}.{name}"
            self.out["references"][full] = {
                "type": "imP",
                "id": eid,
                "polDeg": self.pol_deg,
                "isArray": False,
            }
            self.out["nIm"] += 1

    def _add_reference(self, name, ref_type, length):
        full = f"{self.namespace}.{name}"
        counter = "nConstants" if ref_type == "constP" else "nCommitments"
        ref = {
            "type": ref_type,
            "id": self.out[counter],
            "polDeg": self.pol_deg,
            "isArray": length is not None,
        }
        if length is not None:
            ref["len"] = length
            self.out[counter] += length
        else:
            self.out[counter] += 1
        self.out["references"][full] = ref

    def parse_public(self):
        self.expect("public")
        name = self.next()[1]
        self.expect("=")
        ref, idx_off = self.parse_pol_ref()
        self.expect("(")
        idx = self.parse_int_expr()
        self.expect(")")
        self.expect(";")
        pub_id = len(self.out["publics"])
        pol_type = ref["type"]
        pol_id = ref["id"] + idx_off
        self.out["publics"].append(
            {"name": name, "polType": pol_type, "polId": pol_id, "idx": idx, "id": pub_id}
        )

    def parse_identity_like(self):
        """Identity, plookup, permutation, or connection — disambiguated by
        the top-level keyword in/is/connect, as pilcom's grammar does."""
        start = self.i
        depth = 0
        stmt_kind = "identity"
        while True:
            kind, val = self.peek(self.i - start)
            j = self.i
            # scan forward manually
            break
        # linear scan to the terminating ';' at depth 0
        k = self.i
        while True:
            kind, val = self.tokens[k]
            if kind == "eof":
                raise PilError("Unterminated statement")
            if val in "([{":
                depth += 1
            elif val in ")]}":
                depth -= 1
            elif depth == 0 and val in ("in", "is", "connect"):
                stmt_kind = val
            elif depth == 0 and val == ";":
                break
            k += 1

        if stmt_kind == "identity":
            lhs = self.parse_expr()
            self.expect("=")
            rhs = self.parse_expr()
            self.expect(";")
            e = {"op": "sub", "values": [lhs, rhs]}
            eid = len(self.out["expressions"])
            self.out["expressions"].append(e)
            self.out["polIdentities"].append({"e": eid})
        elif stmt_kind == "connect":
            pols = self.parse_brace_expr_ids()
            self.expect("connect")
            connections = self.parse_brace_expr_ids()
            self.expect(";")
            self.out["connectionIdentities"].append(
                {"pols": pols, "connections": connections}
            )
        else:
            sel_f, f_ids = self.parse_lookup_side()
            self.expect(stmt_kind)  # "in" or "is"
            sel_t, t_ids = self.parse_lookup_side()
            self.expect(";")
            ident = {"f": f_ids, "t": t_ids, "selF": sel_f, "selT": sel_t}
            key = "plookupIdentities" if stmt_kind == "in" else "permutationIdentities"
            self.out[key].append(ident)

    def parse_lookup_side(self):
        sel = None
        if self.peek()[1] != "{":
            sel_expr = self.parse_expr()
            sel = self._push_expr(sel_expr)
        ids = self.parse_brace_expr_ids()
        return sel, ids

    def parse_brace_expr_ids(self):
        self.expect("{")
        ids = []
        while True:
            e = self.parse_expr()
            ids.append(self._push_expr(e))
            if self.peek()[1] == ",":
                self.next()
                continue
            break
        self.expect("}")
        return ids

    def _push_expr(self, e) -> int:
        """Lookup/connection operands are stored as expression indices
        (pilcom stores f/t/pols/connections as expression ids)."""
        eid = len(self.out["expressions"])
        self.out["expressions"].append(e)
        return eid

    # -- expressions --------------------------------------------------------

    def parse_expr(self):
        return self.parse_add()

    def parse_add(self):
        left = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = "add" if self.next()[1] == "+" else "sub"
            right = self.parse_mul()
            left = {"op": op, "values": [left, right]}
        return left

    def parse_mul(self):
        left = self.parse_unary()
        while self.peek()[1] == "*" and self.peek(1)[1] != "*":
            self.next()
            right = self.parse_unary()
            left = {"op": "mul", "values": [left, right]}
        return left

    def parse_unary(self):
        if self.peek()[1] == "-":
            self.next()
            return {"op": "neg", "values": [self.parse_unary()]}
        return self.parse_pow()

    def parse_pow(self):
        base = self.parse_atom()
        if self.peek()[0] == "pow":
            self.next()
            e = self.parse_int_expr_atom()
            res = base
            for _ in range(e - 1):
                res = {"op": "mul", "values": [res, base]}
            return res
        return base

    def parse_atom(self):
        kind, val = self.peek()
        if val == "(":
            self.next()
            e = self.parse_expr()
            self.expect(")")
            e = self._maybe_next(e)
            return e
        if kind == "number":
            self.next()
            return {"op": "number", "value": str(int(val, 0))}
        if kind == "const":
            self.next()
            return {"op": "number", "value": str(self.consts[val])}
        if kind == "pub":
            self.next()
            name = val[1:]
            pub = next(
                (p for p in self.out["publics"] if p["name"] == name), None
            )
            if pub is None:
                raise PilError(f"Unknown public {name}")
            return {"op": "public", "id": pub["id"]}
        if kind == "ident":
            ref, idx_off = self.parse_pol_ref()
            node = self._ref_node(ref, idx_off)
            return self._maybe_next(node)
        raise PilError(f"Unexpected token {val!r} in expression")

    def _maybe_next(self, node):
        while self.peek()[1] == "'":
            self.next()
            if node["op"] in ("cm", "const", "exp"):
                node = dict(node, next=True)
            else:
                raise PilError("Rotation of a non-column expression")
        return node

    def _ref_node(self, ref, idx_off):
        if ref["type"] == "imP":
            return {"op": "exp", "id": ref["id"], "next": False}
        op = "const" if ref["type"] == "constP" else "cm"
        return {"op": op, "id": ref["id"] + idx_off, "next": False}

    def parse_pol_ref(self):
        name = self.next()[1]
        if self.peek()[1] == ".":
            self.next()
            name = f"{name}.{self.next()[1]}"
        else:
            name = f"{self.namespace}.{name}"
        refs = self.out["references"]
        if name not in refs:
            raise PilError(f"Unknown polynomial {name}")
        ref = refs[name]
        idx_off = 0
        if self.peek()[1] == "[":
            self.next()
            idx_off = self.parse_int_expr()
            self.expect("]")
            if not ref.get("isArray"):
                raise PilError(f"{name} is not an array")
        return ref, idx_off

    # -- compile-time integer expressions -----------------------------------

    def parse_int_expr(self):
        v = self.parse_int_mul()
        while self.peek()[1] in ("+", "-"):
            if self.next()[1] == "+":
                v += self.parse_int_mul()
            else:
                v -= self.parse_int_mul()
        return v

    def parse_int_mul(self):
        v = self.parse_int_pow()
        while self.peek()[1] == "*" and self.peek(1)[1] != "*":
            self.next()
            v *= self.parse_int_pow()
        return v

    def parse_int_pow(self):
        v = self.parse_int_expr_atom()
        if self.peek()[0] == "pow":
            self.next()
            v = v ** self.parse_int_pow()
        return v

    def parse_int_expr_atom(self):
        kind, val = self.next()
        if kind == "number":
            return int(val, 0)
        if kind == "const":
            return self.consts[val]
        if val == "(":
            v = self.parse_int_expr()
            self.expect(")")
            return v
        if val == "-":
            return -self.parse_int_expr_atom()
        raise PilError(f"Bad integer expression token {val!r}")


def compile_pil(path: str) -> dict:
    """Compile a .pil file to the pilcom-style pil dict."""
    return Parser().parse_file(path)


def compile_pil_source(src: str, base_dir: str = ".") -> dict:
    return Parser().parse_source(src, base_dir=base_dir)
