"""Minimal in-process EVM: enough of the Ethereum VM to EXECUTE the
vendored deposit-contract bytecode instead of trusting it.

Role analogue: the reference runs its compiled deposit contract under
web3/eth-tester for behavioral tests
(solidity_deposit_contract/web3_tester/tests/test_deposit.py:1-194); this
interpreter is that capability without the web3 stack — a stack machine
over the solc 0.6 opcode subset, word-addressed memory, a storage dict,
LOG collection, and the SHA-256 precompile (address 0x2) the deposit
contract's incremental merkle tree leans on.  Gas is not metered (the
tests assert behavior, not gas).

Differential harness: tests/test_torch_deposit_contract.py deploys the
port's vendored artifact (``vendor/deposit_contract/``), drives deposit()
sequences, and cross-checks logs + get_deposit_root() against
``deposit_contract.DepositTree`` and the SSZ list root, step by step.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .keccak import keccak256, selector

__all__ = ["Contract", "EvmRevert", "deploy", "keccak256", "selector",
           "encode_abi", "decode_abi"]

_U256 = (1 << 256) - 1
_SIGN_BIT = 1 << 255


class EvmRevert(Exception):
    """REVERT executed; .data carries the returned reason bytes."""

    def __init__(self, data: bytes):
        super().__init__(data.hex() or "reverted")
        self.data = data


@dataclass
class Log:
    topics: List[int]
    data: bytes


@dataclass
class _Ctx:
    code: bytes
    calldata: bytes
    value: int
    storage: Dict[int, int]
    static: bool = False
    logs: List[Log] = field(default_factory=list)


def _run(ctx: _Ctx) -> bytes:
    stack: List[int] = []
    mem = bytearray()
    code = ctx.code
    returndata = b""
    pc = 0

    def push(v: int) -> None:
        stack.append(v & _U256)

    def pop() -> int:
        return stack.pop()

    def mgrow(end: int) -> None:
        if end > len(mem):
            mem.extend(b"\x00" * (((end + 31) // 32) * 32 - len(mem)))

    def mload(off: int, n: int) -> bytes:
        mgrow(off + n)
        return bytes(mem[off:off + n])

    def mstore_bytes(off: int, data: bytes) -> None:
        if not data:
            return
        mgrow(off + len(data))
        mem[off:off + len(data)] = data

    steps = 0
    while pc < len(code):
        steps += 1
        if steps > 10_000_000:
            raise RuntimeError("EVM step limit exceeded")
        op = code[pc]
        pc += 1

        if 0x60 <= op <= 0x7F:  # PUSH1..PUSH32
            n = op - 0x5F
            push(int.from_bytes(code[pc:pc + n], "big"))
            pc += n
        elif 0x80 <= op <= 0x8F:  # DUP1..DUP16
            push(stack[-(op - 0x7F)])
        elif 0x90 <= op <= 0x9F:  # SWAP1..SWAP16
            i = op - 0x8F
            stack[-1], stack[-1 - i] = stack[-1 - i], stack[-1]
        elif op == 0x00:  # STOP
            return b""
        elif op == 0x01:
            push(pop() + pop())
        elif op == 0x02:
            push(pop() * pop())
        elif op == 0x03:
            a, b = pop(), pop()
            push(a - b)
        elif op == 0x04:
            a, b = pop(), pop()
            push(0 if b == 0 else a // b)
        elif op == 0x05:  # SDIV
            a, b = pop(), pop()
            sa = a - (1 << 256) if a & _SIGN_BIT else a
            sb = b - (1 << 256) if b & _SIGN_BIT else b
            push(0 if sb == 0 else abs(sa) // abs(sb) * (1 if (sa < 0) == (sb < 0) else -1))
        elif op == 0x06:
            a, b = pop(), pop()
            push(0 if b == 0 else a % b)
        elif op == 0x08:  # ADDMOD
            a, b, n = pop(), pop(), pop()
            push(0 if n == 0 else (a + b) % n)
        elif op == 0x09:  # MULMOD
            a, b, n = pop(), pop(), pop()
            push(0 if n == 0 else (a * b) % n)
        elif op == 0x0A:  # EXP
            a, b = pop(), pop()
            push(pow(a, b, 1 << 256))
        elif op == 0x0B:  # SIGNEXTEND
            k, v = pop(), pop()
            if k < 31:
                bit = 8 * (k + 1) - 1
                if v & (1 << bit):
                    v |= _U256 ^ ((1 << (bit + 1)) - 1)
                else:
                    v &= (1 << (bit + 1)) - 1
            push(v)
        elif op == 0x10:
            a, b = pop(), pop()
            push(1 if a < b else 0)
        elif op == 0x11:
            a, b = pop(), pop()
            push(1 if a > b else 0)
        elif op == 0x12:  # SLT
            a, b = pop(), pop()
            sa = a - (1 << 256) if a & _SIGN_BIT else a
            sb = b - (1 << 256) if b & _SIGN_BIT else b
            push(1 if sa < sb else 0)
        elif op == 0x13:  # SGT
            a, b = pop(), pop()
            sa = a - (1 << 256) if a & _SIGN_BIT else a
            sb = b - (1 << 256) if b & _SIGN_BIT else b
            push(1 if sa > sb else 0)
        elif op == 0x14:
            push(1 if pop() == pop() else 0)
        elif op == 0x15:
            push(1 if pop() == 0 else 0)
        elif op == 0x16:
            push(pop() & pop())
        elif op == 0x17:
            push(pop() | pop())
        elif op == 0x18:
            push(pop() ^ pop())
        elif op == 0x19:
            push(~pop())
        elif op == 0x1A:  # BYTE
            i, x = pop(), pop()
            push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
        elif op == 0x1B:  # SHL
            s, v = pop(), pop()
            push(0 if s >= 256 else v << s)
        elif op == 0x1C:  # SHR
            s, v = pop(), pop()
            push(0 if s >= 256 else v >> s)
        elif op == 0x1D:  # SAR
            s, v = pop(), pop()
            sv = v - (1 << 256) if v & _SIGN_BIT else v
            push((sv >> min(s, 255)))
        elif op == 0x20:  # SHA3 (keccak256)
            off, n = pop(), pop()
            push(int.from_bytes(keccak256(mload(off, n)), "big"))
        elif op == 0x30:  # ADDRESS
            push(0xDE9052717)
        elif op == 0x33:  # CALLER
            push(0xCA11E4)
        elif op == 0x34:  # CALLVALUE
            push(ctx.value)
        elif op == 0x35:  # CALLDATALOAD
            off = pop()
            chunk = ctx.calldata[off:off + 32]
            push(int.from_bytes(chunk.ljust(32, b"\x00"), "big"))
        elif op == 0x36:
            push(len(ctx.calldata))
        elif op == 0x37:  # CALLDATACOPY
            doff, soff, n = pop(), pop(), pop()
            chunk = ctx.calldata[soff:soff + n].ljust(n, b"\x00")
            mstore_bytes(doff, chunk)
        elif op == 0x38:
            push(len(code))
        elif op == 0x39:  # CODECOPY
            doff, soff, n = pop(), pop(), pop()
            chunk = code[soff:soff + n].ljust(n, b"\x00")
            mstore_bytes(doff, chunk)
        elif op == 0x3D:
            push(len(returndata))
        elif op == 0x3E:  # RETURNDATACOPY
            doff, soff, n = pop(), pop(), pop()
            if soff + n > len(returndata):  # hard EVM fault, not an assert:
                raise EvmRevert(b"returndata out of bounds")  # -O must not strip
            mstore_bytes(doff, returndata[soff:soff + n])
        elif op == 0x47:  # SELFBALANCE
            push(0)
        elif op == 0x50:
            pop()
        elif op == 0x51:
            push(int.from_bytes(mload(pop(), 32), "big"))
        elif op == 0x52:
            off, v = pop(), pop()
            mstore_bytes(off, v.to_bytes(32, "big"))
        elif op == 0x53:
            off, v = pop(), pop()
            mstore_bytes(off, bytes([v & 0xFF]))
        elif op == 0x54:
            push(ctx.storage.get(pop(), 0))
        elif op == 0x55:
            if ctx.static:
                raise EvmRevert(b"SSTORE in static context")
            k, v = pop(), pop()
            if v == 0:
                ctx.storage.pop(k, None)
            else:
                ctx.storage[k] = v
        elif op == 0x56:  # JUMP
            dest = pop()
            if dest >= len(code) or code[dest] != 0x5B:
                raise EvmRevert(b"bad jumpdest")
            pc = dest
        elif op == 0x57:  # JUMPI
            dest, cond = pop(), pop()
            if cond:
                if dest >= len(code) or code[dest] != 0x5B:
                    raise EvmRevert(b"bad jumpdest")
                pc = dest
        elif op == 0x58:
            push(pc - 1)
        elif op == 0x59:
            push(len(mem))
        elif op == 0x5A:  # GAS (not metered)
            push(10**12)
        elif op == 0x5B:  # JUMPDEST
            pass
        elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
            if ctx.static:
                raise EvmRevert(b"LOG in static context")
            off, n = pop(), pop()
            topics = [pop() for _ in range(op - 0xA0)]
            ctx.logs.append(Log(topics, mload(off, n)))
        elif op in (0xF1, 0xFA):  # CALL / STATICCALL (precompiles only)
            if op == 0xF1:
                _gas, addr, _value, in_off, in_n, out_off, out_n = (
                    pop(), pop(), pop(), pop(), pop(), pop(), pop())
            else:
                _gas, addr, in_off, in_n, out_off, out_n = (
                    pop(), pop(), pop(), pop(), pop(), pop())
            data = mload(in_off, in_n)
            if addr == 2:  # SHA-256 precompile
                returndata = hashlib.sha256(data).digest()
            elif addr == 4:  # identity
                returndata = data
            else:
                raise NotImplementedError(f"CALL to address {addr:#x}")
            mstore_bytes(out_off, returndata[:out_n])
            push(1)
        elif op == 0xF3:  # RETURN
            off, n = pop(), pop()
            return mload(off, n)
        elif op == 0xFD:  # REVERT
            off, n = pop(), pop()
            raise EvmRevert(mload(off, n))
        elif op == 0xFE:  # INVALID
            raise EvmRevert(b"invalid opcode")
        else:
            raise NotImplementedError(f"opcode {op:#04x} at {pc - 1}")
    return b""


# --------------------------------------------------------------------------
# ABI (the subset the deposit contract's interface needs)
# --------------------------------------------------------------------------

def encode_abi(types: List[str], args: List) -> bytes:
    """Head/tail ABI encoding for static words, bytes32 and dynamic bytes."""
    heads: List[Optional[bytes]] = []
    tails: List[bytes] = []
    for typ, arg in zip(types, args):
        if typ == "bytes":
            heads.append(None)  # placeholder: offset
            raw = bytes(arg)
            tails.append(len(raw).to_bytes(32, "big")
                         + raw.ljust(((len(raw) + 31) // 32) * 32, b"\x00"))
        elif typ == "bytes32":
            heads.append(bytes(arg).ljust(32, b"\x00"))
            tails.append(b"")
        elif typ in ("uint256", "uint64", "bool"):
            heads.append(int(arg).to_bytes(32, "big"))
            tails.append(b"")
        elif typ == "bytes4":
            heads.append(bytes(arg).ljust(32, b"\x00"))
            tails.append(b"")
        else:
            raise NotImplementedError(typ)
    head_size = 32 * len(heads)
    out = b""
    tail_off = head_size
    tail_blob = b""
    for head, tail in zip(heads, tails):
        if head is None:
            out += tail_off.to_bytes(32, "big")
            tail_blob += tail
            tail_off += len(tail)
        else:
            out += head
    return out + tail_blob


def decode_abi(types: List[str], data: bytes) -> List:
    out = []
    for i, typ in enumerate(types):
        word = data[32 * i:32 * i + 32]
        if typ == "bytes32":
            out.append(word)
        elif typ in ("uint256", "uint64"):
            out.append(int.from_bytes(word, "big"))
        elif typ == "bool":
            out.append(bool(int.from_bytes(word, "big")))
        elif typ == "bytes":
            off = int.from_bytes(word, "big")
            n = int.from_bytes(data[off:off + 32], "big")
            out.append(data[off + 32:off + 32 + n])
        else:
            raise NotImplementedError(typ)
    return out


# --------------------------------------------------------------------------
# contract object
# --------------------------------------------------------------------------

class Contract:
    """A deployed contract: runtime code + persistent storage + log sink."""

    def __init__(self, runtime: bytes, storage: Dict[int, int]):
        self.runtime = runtime
        self.storage = storage
        self.logs: List[Log] = []

    def call(self, signature: str, types: List[str], args: List,
             value: int = 0, static: bool = False) -> bytes:
        calldata = selector(signature) + encode_abi(types, args)
        # run against a storage snapshot: EVM revert semantics discard ALL
        # state effects of the failed call (logs are discarded implicitly —
        # ctx.logs only merges on success)
        working = dict(self.storage)
        ctx = _Ctx(code=self.runtime, calldata=calldata, value=value,
                   storage=working, static=static)
        ret = _run(ctx)
        self.storage = working
        self.logs.extend(ctx.logs)
        return ret


def deploy(deployment_bytecode: bytes) -> Contract:
    """Run the constructor; its RETURN is the runtime code, its SSTOREs
    persist into the contract's storage."""
    storage: Dict[int, int] = {}
    ctx = _Ctx(code=deployment_bytecode, calldata=b"", value=0,
               storage=storage)
    runtime = _run(ctx)
    assert runtime, "constructor returned no runtime code"
    return Contract(runtime, storage)
