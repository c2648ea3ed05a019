"""EVM bytecode backend for the generated pil-fflonk Solidity verifier.

Two halves:

1. ``compile_verifier`` — a bytecode compiler for the restricted
   statement language fflonk/solidity.py emits (mulmod/addmod slots,
   modexp/ecAdd/ecMul/pairing precompile calls, keccak transcript
   hashes, range/equality guards).  This is the in-repo "solc" for the
   generated contract: every statement lowers to real EVM opcodes over
   the standard calldata ABI (4-byte selector + head-encoded fixed
   arrays) and byte-addressed memory.

2. ``EVM`` — an EVM-subset interpreter with the Yellow-Paper semantics
   the contract exercises: 256-bit word stack machine, memory expansion
   gas, keccak word gas, STATICCALL into the BN254 precompiles
   (0x05 modexp per EIP-2565, 0x06/0x07 per EIP-1108, 0x08 pairing),
   JUMPDEST validation, RETURN/REVERT.

Together they give the acceptance test the reference only gets by
deploying verifier_pilfflonk.sol.ejs output under hardhat
(pil2-stark-js smart_contract_tests/): the emitted verifier runs as
compiled code against real calldata and must accept the live proof and
reject corrupted calldata — with a gas number.
"""
from __future__ import annotations

from ..curve import bn254
from ..ops.fft_bn128 import FR
from ..protocol.keccak import keccak256

FQ = bn254.Q

# ---------------------------------------------------------------------------
# opcodes

STOP, ADD, MUL, SUB, DIV, MOD = 0x00, 0x01, 0x02, 0x03, 0x04, 0x06
ADDMOD, MULMOD, EXP = 0x08, 0x09, 0x0A
LT, GT, EQ, ISZERO, AND, OR, XOR, NOT = 0x10, 0x11, 0x14, 0x15, 0x16, 0x17, 0x18, 0x19
KECCAK256 = 0x20
CALLDATALOAD, CALLDATASIZE = 0x35, 0x36
POP, MLOAD, MSTORE = 0x50, 0x51, 0x52
JUMP, JUMPI, PC, MSIZE, GAS, JUMPDEST = 0x56, 0x57, 0x58, 0x59, 0x5A, 0x5B
PUSH0 = 0x5F
DUP1 = 0x80
SWAP1 = 0x90
STATICCALL = 0xFA
RETURN, REVERT = 0xF3, 0xFD

_GAS = {
    STOP: 0, ADD: 3, MUL: 5, SUB: 3, DIV: 5, MOD: 5, ADDMOD: 8, MULMOD: 8,
    LT: 3, GT: 3, EQ: 3, ISZERO: 3, AND: 3, OR: 3, XOR: 3, NOT: 3,
    CALLDATALOAD: 3, CALLDATASIZE: 2, POP: 2, MLOAD: 3, MSTORE: 3,
    JUMP: 8, JUMPI: 10, PC: 2, MSIZE: 2, GAS: 2, JUMPDEST: 1, PUSH0: 2,
    KECCAK256: 30, STATICCALL: 100, RETURN: 0, REVERT: 0, EXP: 10,
}


class _Asm:
    def __init__(self):
        self.code = bytearray()
        self.fixups = []  # (pos, label)
        self.labels = {}

    def op(self, *ops):
        self.code.extend(ops)

    def push(self, v: int):
        v = int(v)
        if v == 0:
            self.code.append(PUSH0)
            return
        b = v.to_bytes((v.bit_length() + 7) // 8, "big")
        self.code.append(0x5F + len(b))  # PUSH1..PUSH32
        self.code.extend(b)

    def push_label(self, label: str):
        self.code.append(0x5F + 4)  # PUSH4 placeholder
        self.fixups.append((len(self.code), label))
        self.code.extend(b"\0\0\0\0")

    def label(self, name: str):
        self.labels[name] = len(self.code)
        self.code.append(JUMPDEST)

    def dup(self, n=1):
        self.code.append(DUP1 + n - 1)

    def swap(self, n=1):
        self.code.append(SWAP1 + n - 1)

    def assemble(self) -> bytes:
        for pos, label in self.fixups:
            tgt = self.labels[label]
            self.code[pos:pos + 4] = tgt.to_bytes(4, "big")
        return bytes(self.code)


# ---------------------------------------------------------------------------
# compiler: _Emit.ops -> bytecode


def compile_verifier(ops, n_words: int, n_publics: int, n_slots: int) -> bytes:
    """Compile the statement stream into runtime bytecode for
    verifyProof(uint256[n_words],uint256[n_publics]) -> bool."""
    SLOT_BASE = 0x80
    SCRATCH = SLOT_BASE + 32 * n_slots  # precompile io + hash buffer

    a = _Asm()

    def slot_off(expr: str) -> int:
        assert expr.startswith("m[") and expr.endswith("]"), expr
        return SLOT_BASE + 32 * int(expr[2:-1])

    def load(expr):
        """Push the value of an operand expression."""
        if isinstance(expr, int):
            a.push(expr % (1 << 256))
            return
        expr = expr.strip()
        if expr.startswith("m["):
            a.push(slot_off(expr))
            a.op(MLOAD)
        elif expr.startswith("proof["):
            i = int(expr[6:-1])
            a.push(4 + 32 * i)
            a.op(CALLDATALOAD)
        elif expr.startswith("pubs["):
            i = int(expr[5:-1])
            a.push(4 + 32 * (n_words + i))
            a.op(CALLDATALOAD)
        else:
            a.push(int(expr) % (1 << 256))

    def store(expr: str):
        a.push(slot_off(expr))
        a.op(MSTORE)

    def modexp_call():
        """Input (base, exp) on stack (base deeper). Calls 0x05 with
        32-byte b/e/m at SCRATCH, leaves result on stack."""
        # stack: base exp   (exp on top)
        a.push(SCRATCH + 0x80)
        a.op(MSTORE)  # exp
        a.push(SCRATCH + 0x60)
        a.op(MSTORE)  # base
        for off, v in ((0x00, 32), (0x20, 32), (0x40, 32)):
            a.push(v)
            a.push(SCRATCH + off)
            a.op(MSTORE)
        a.push(FR)
        a.push(SCRATCH + 0xA0)
        a.op(MSTORE)
        # staticcall(gas, 5, SCRATCH, 0xc0, SCRATCH, 0x20)
        a.push(0x20)
        a.push(SCRATCH)
        a.push(0xC0)
        a.push(SCRATCH)
        a.push(5)
        a.op(GAS)
        a.op(STATICCALL)
        a.op(ISZERO)
        a.push_label("revert")
        a.op(JUMPI)
        a.push(SCRATCH)
        a.op(MLOAD)

    for op in ops:
        kind = op[0]
        if kind in ("mul", "add"):
            _, d, x, y = op
            a.push(FR)
            load(y)
            load(x)
            a.op(MULMOD if kind == "mul" else ADDMOD)
            store(d)
        elif kind == "sub":
            _, d, x, y = op
            a.push(FR)
            load(y)
            a.push(FR)
            a.op(SUB)  # q - y
            load(x)
            a.op(ADDMOD)
            store(d)
        elif kind == "expmod":
            _, d, b_, e_ = op
            load(b_)
            load(e_)
            modexp_call()
            store(d)
        elif kind == "inv":
            _, d, x = op
            load(x)
            a.push(FR - 2)
            modexp_call()
            store(d)
        elif kind == "hash":
            _, d, parts = op
            for j, part in enumerate(parts):
                load(part)
                a.push(SCRATCH + 32 * j)
                a.op(MSTORE)
            a.push(FR)
            a.push(32 * len(parts))
            a.push(SCRATCH)
            a.op(KECCAK256)
            a.op(MOD)
            store(d)
        elif kind == "ecadd":
            _, dx, dy, ax, ay, bx, by = op
            for j, v in enumerate((ax, ay, bx, by)):
                load(v)
                a.push(SCRATCH + 32 * j)
                a.op(MSTORE)
            a.push(0x40)
            a.push(SCRATCH)
            a.push(0x80)
            a.push(SCRATCH)
            a.push(6)
            a.op(GAS)
            a.op(STATICCALL)
            a.op(ISZERO)
            a.push_label("revert")
            a.op(JUMPI)
            a.push(SCRATCH)
            a.op(MLOAD)
            store(dx)
            a.push(SCRATCH + 0x20)
            a.op(MLOAD)
            store(dy)
        elif kind == "ecmul":
            _, dx, dy, ax, ay, s_ = op
            for j, v in enumerate((ax, ay, s_)):
                load(v)
                a.push(SCRATCH + 32 * j)
                a.op(MSTORE)
            a.push(0x40)
            a.push(SCRATCH)
            a.push(0x60)
            a.push(SCRATCH)
            a.push(7)
            a.op(GAS)
            a.op(STATICCALL)
            a.op(ISZERO)
            a.push_label("revert")
            a.op(JUMPI)
            a.push(SCRATCH)
            a.op(MLOAD)
            store(dx)
            a.push(SCRATCH + 0x20)
            a.op(MLOAD)
            store(dy)
        elif kind == "negy":
            _, d, y = op
            # y == 0 ? 0 : qf - y   ==  (qf - y) * !iszero(y)  via branchless
            # mulmod((qf - y), 1, qf) is wrong for y=0 -> use mod:
            # (qf - y) mod qf  ==  qf-y for y>0, 0 for y=0
            a.push(FQ)
            load(y)
            a.push(FQ)
            a.op(SUB)  # qf - y
            a.op(MOD)
            store(d)
        elif kind == "check_eq":
            _, x, y = op
            load(x)
            load(y)
            a.op(EQ)
            a.op(ISZERO)
            a.push_label("fail")
            a.op(JUMPI)
        elif kind == "check_range":
            _, x = op
            a.push(FR)
            load(x)
            a.op(LT)  # x < q
            a.op(ISZERO)
            a.push_label("fail")
            a.op(JUMPI)
        elif kind == "pairing_ret":
            (_, args) = op
            for j, v in enumerate(args):
                load(v)
                a.push(SCRATCH + 32 * j)
                a.op(MSTORE)
            a.push(0x20)
            a.push(SCRATCH)
            a.push(0x180)
            a.push(SCRATCH)
            a.push(8)
            a.op(GAS)
            a.op(STATICCALL)
            a.op(ISZERO)
            a.push_label("revert")
            a.op(JUMPI)
            # return bool(precompile output)
            a.push(SCRATCH)
            a.op(MLOAD)
            a.push(1)
            a.op(EQ)
            a.push(0)
            a.op(MSTORE)
            a.push(0x20)
            a.push(0)
            a.op(RETURN)

    a.label("fail")
    a.push(0)
    a.push(0)
    a.op(MSTORE)
    a.push(0x20)
    a.push(0)
    a.op(RETURN)
    a.label("revert")
    a.push(0)
    a.push(0)
    a.op(REVERT)
    return a.assemble()


def encode_calldata(proof_words, publics) -> bytes:
    """verifyProof(uint256[N],uint256[P]) ABI calldata (fixed-size arrays
    are head-encoded in place)."""
    selector = keccak256(
        f"verifyProof(uint256[{len(proof_words)}],uint256[{len(publics)}])".encode()
    )[:4]
    out = bytearray(selector)
    for v in list(proof_words) + list(publics):
        out += int(v).to_bytes(32, "big")
    return bytes(out)


# ---------------------------------------------------------------------------
# interpreter

_U256 = (1 << 256) - 1


class EVMError(Exception):
    pass


class OutOfGas(EVMError):
    pass


class Revert(EVMError):
    pass


def _ec_decode(data: bytes, n_words: int):
    data = data.ljust(32 * n_words, b"\0")
    return [int.from_bytes(data[32 * i:32 * (i + 1)], "big")
            for i in range(n_words)]


def _precompile(addr: int, data: bytes):
    """Returns (ok, output, gas_cost) for the precompiles the verifier
    uses; gas per EIP-2565 / EIP-1108."""
    if addr == 5:  # modexp
        words = _ec_decode(data, 3)
        bl, el, ml = words
        rest = data[96:].ljust(bl + el + ml, b"\0")
        b = int.from_bytes(rest[:bl], "big")
        e = int.from_bytes(rest[bl:bl + el], "big")
        m = int.from_bytes(rest[bl + el:bl + el + ml], "big")
        mult = (max(bl, ml) + 7) // 8
        it = max(1, e.bit_length() - 1 if el <= 32 else 8 * (el - 32))
        gas = max(200, mult * mult * it // 3)
        out = (pow(b, e, m) if m else 0).to_bytes(ml, "big")
        return True, out, gas
    if addr == 6:  # bn254 add
        x1, y1, x2, y2 = _ec_decode(data, 4)
        try:
            p = bn254.g1_add(_pt(x1, y1), _pt(x2, y2))
        except Exception:
            return False, b"", 150
        return True, _pt_bytes(p), 150
    if addr == 7:  # bn254 scalar mul
        x1, y1, s = _ec_decode(data, 3)
        try:
            p = bn254.g1_mul(_pt(x1, y1), s)
        except Exception:
            return False, b"", 6000
        return True, _pt_bytes(p), 6000
    if addr == 8:  # pairing
        if len(data) % 192:
            return False, b"", 45000
        k = len(data) // 192
        gas = 45000 + 34000 * k
        pairs = []
        try:
            for i in range(k):
                w = _ec_decode(data[192 * i:192 * (i + 1)], 6)
                g1 = _pt(w[0], w[1])
                # EIP-197 word order: x_c1, x_c0, y_c1, y_c0
                g2 = ((w[3], w[2]), (w[5], w[4]))
                if g1 is None or g2 == ((0, 0), (0, 0)):
                    continue
                pairs.append((g1, g2))
            ok = bn254.pairing_check(pairs)
        except Exception:
            return False, b"", gas
        return True, int(ok).to_bytes(32, "big"), gas
    return False, b"", 0


def _pt(x, y):
    if x == 0 and y == 0:
        return None
    if (y * y - (x * x * x + 3)) % FQ:
        raise ValueError("point not on curve")
    return (x, y)


def _pt_bytes(p):
    if p is None:
        return bytes(64)
    return int(p[0]).to_bytes(32, "big") + int(p[1]).to_bytes(32, "big")


class EVM:
    """Minimal-but-faithful EVM for the verifier's opcode subset."""

    def __init__(self, code: bytes, gas_limit: int = 300_000_000):
        self.code = code
        self.gas_limit = gas_limit
        self.jumpdests = {
            i for i, b in enumerate(code)
            if b == JUMPDEST and not self._in_pushdata(i)
        }

    def _in_pushdata(self, pos: int) -> bool:
        i = 0
        while i < pos:
            b = self.code[i]
            i += 1 + (b - 0x5F if 0x60 <= b <= 0x7F else 0)
        return i != pos

    def call(self, calldata: bytes):
        """Returns (returndata, gas_used); raises Revert/OutOfGas."""
        code = self.code
        stack: list[int] = []
        mem = bytearray()
        gas = self.gas_limit
        mem_words = 0

        def use(g):
            nonlocal gas
            gas -= g
            if gas < 0:
                raise OutOfGas()

        def mem_expand(end: int):
            nonlocal mem_words
            if end == 0:
                return
            w = (end + 31) // 32
            if w > mem_words:
                use((3 * w + w * w // 512) - (3 * mem_words + mem_words * mem_words // 512))
                mem_words = w
                if len(mem) < 32 * w:
                    mem.extend(bytes(32 * w - len(mem)))

        pc = 0
        while pc < len(code):
            op = code[pc]
            if 0x60 <= op <= 0x7F:  # PUSH1..32
                n = op - 0x5F
                use(3)
                stack.append(int.from_bytes(code[pc + 1:pc + 1 + n], "big"))
                pc += 1 + n
                continue
            if 0x80 <= op <= 0x8F:  # DUP
                use(3)
                stack.append(stack[-(op - 0x7F)])
                pc += 1
                continue
            if 0x90 <= op <= 0x9F:  # SWAP
                n = op - 0x8F
                use(3)
                stack[-1], stack[-1 - n] = stack[-1 - n], stack[-1]
                pc += 1
                continue
            use(_GAS.get(op, 3))
            if op == PUSH0:
                stack.append(0)
            elif op == STOP:
                return b"", self.gas_limit - gas
            elif op in (ADD, MUL, SUB, DIV, MOD, LT, GT, EQ, AND, OR, XOR):
                x = stack.pop()
                y = stack.pop()
                if op == ADD:
                    v = (x + y) & _U256
                elif op == MUL:
                    v = (x * y) & _U256
                elif op == SUB:
                    v = (x - y) & _U256
                elif op == DIV:
                    v = x // y if y else 0
                elif op == MOD:
                    v = x % y if y else 0
                elif op == LT:
                    v = int(x < y)
                elif op == GT:
                    v = int(x > y)
                elif op == EQ:
                    v = int(x == y)
                elif op == AND:
                    v = x & y
                elif op == OR:
                    v = x | y
                else:
                    v = x ^ y
                stack.append(v)
            elif op in (ADDMOD, MULMOD):
                x, y, m = stack.pop(), stack.pop(), stack.pop()
                stack.append(((x + y) % m if op == ADDMOD else (x * y) % m) if m else 0)
            elif op == EXP:
                x, e = stack.pop(), stack.pop()
                use(50 * ((e.bit_length() + 7) // 8))
                stack.append(pow(x, e, 1 << 256))
            elif op == ISZERO:
                stack.append(int(stack.pop() == 0))
            elif op == NOT:
                stack.append(stack.pop() ^ _U256)
            elif op == KECCAK256:
                off, size = stack.pop(), stack.pop()
                mem_expand(off + size)
                use(6 * ((size + 31) // 32))
                stack.append(int.from_bytes(keccak256(bytes(mem[off:off + size])), "big"))
            elif op == CALLDATALOAD:
                off = stack.pop()
                stack.append(int.from_bytes(
                    calldata[off:off + 32].ljust(32, b"\0"), "big"))
            elif op == CALLDATASIZE:
                stack.append(len(calldata))
            elif op == POP:
                stack.pop()
            elif op == MLOAD:
                off = stack.pop()
                mem_expand(off + 32)
                stack.append(int.from_bytes(mem[off:off + 32], "big"))
            elif op == MSTORE:
                off, v = stack.pop(), stack.pop()
                mem_expand(off + 32)
                mem[off:off + 32] = v.to_bytes(32, "big")
            elif op == JUMP:
                pc = stack.pop()
                if pc not in self.jumpdests:
                    raise EVMError("bad jump")
                continue
            elif op == JUMPI:
                tgt, cond = stack.pop(), stack.pop()
                if cond:
                    if tgt not in self.jumpdests:
                        raise EVMError("bad jump")
                    pc = tgt
                    continue
            elif op == PC:
                stack.append(pc)
            elif op == MSIZE:
                stack.append(32 * mem_words)
            elif op == GAS:
                stack.append(gas)
            elif op == JUMPDEST:
                pass
            elif op == STATICCALL:
                g = stack.pop()
                addr = stack.pop()
                in_off, in_size = stack.pop(), stack.pop()
                out_off, out_size = stack.pop(), stack.pop()
                mem_expand(in_off + in_size)
                mem_expand(out_off + out_size)
                ok, out, cost = _precompile(addr, bytes(mem[in_off:in_off + in_size]))
                use(min(cost, g))
                if ok:
                    mem[out_off:out_off + min(out_size, len(out))] = \
                        out[:out_size]
                stack.append(int(ok))
            elif op == RETURN:
                off, size = stack.pop(), stack.pop()
                mem_expand(off + size)
                return bytes(mem[off:off + size]), self.gas_limit - gas
            elif op == REVERT:
                off, size = stack.pop(), stack.pop()
                raise Revert(bytes(mem[off:off + size]))
            else:
                raise EVMError(f"unsupported opcode {op:#x} at {pc}")
            pc += 1
        return b"", self.gas_limit - gas


def run_verifier(vk, fflonk_info, verifier_info, proof_words, publics):
    """Compile the generated contract to bytecode and execute it on the
    ABI calldata.  Returns (accepted: bool, gas_used: int)."""
    from . import solidity as sol

    _, em, n_words, n_publics = sol.export_pilfflonk_verifier(
        vk, fflonk_info, verifier_info, return_ops=True
    )
    code = compile_verifier(em.ops, n_words, n_publics, em.n_slots)
    calldata = encode_calldata(proof_words, publics)
    out, gas = EVM(code).call(calldata)
    return int.from_bytes(out, "big") == 1, gas
