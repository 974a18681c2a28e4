"""The fixed schedules K4 and K5 run: one Miller doubling step, one Fq12
squaring, as phases of independent Fq operations on shared-memory slots.

A K4 or K5 thread block carries one batch item.  The item's state (f, and
T = (X, Y, Z) and P = (px, py) for each pair) lives in shared memory, one
Fq element a slot, for the whole run, and a step of the run is a fixed list
of phases separated by ``__syncthreads()``.  A phase is a set of
independent operations, one to a thread:

* ``MUL``: slot <- mul(a, b), where a and b are lazy linear combinations
  of slots with small integer coefficients (K3's product, ``bls_fq.cuh``);
* ``RENORM``: slot <- renorm(c) for such a combination c.

The tables are recorded from the torch formulas themselves
(``pairing._dbl_run_step``, ``tower.fq12_square``): these run once on a
recording limb type whose "limbs" are coefficient vectors over the
variables (the inputs, then every product and renorm in the order made),
so every addition, subtraction, small multiple, stack, gather and fold of
the formulas composes into one linear combination, and every
``limbs.mul`` and ``limbs.renorm`` becomes one operation.  A renorm of a
product or of a renorm changes no limb and is dropped.  Each operation is
placed in the first phase after its operands exist, and each variable
gets a slot that is reused once the variable has been read for the last
time; a step's outputs are written over its inputs.  Which values are
multiplied and which sums renormalized are the plain version's, and every
limb the limb code makes depends only on those integer values, so running
a table gives ``pairing._dbl_run_plain`` / ``_sq_run_plain``'s limbs bit
for bit: ``run_plain`` runs the encoded tables in torch, and the tests
hold it so on the CPU.

``python -m consensus_specs_tpu_torch.ops.bls.schedule`` writes the tables
into ``csrc/bls_miller_schedule.cuh``, which K4 and K5 compile in; a test
checks that the file is what the formulas give now.  Recording swaps the
module's ``limbs.mul`` and ``limbs.renorm`` for the recorder's while it
runs, so it is for that script and the tests, never a running pipeline.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from . import limbs, pairing, tower

MUL, RENORM = 0, 1
# tables: index 0 the squaring (K5), index k the doubling step at k pairs
SQ = 0
# slots a pair takes: X, Y, Z (two each), px, py
PAIR_SLOTS = 8
F_SLOTS = 12
# the block's threads: enough for the widest phase, its MULs in whole
# warps and then its other operations, at most MAX_THREADS (a wider phase
# takes its operations in turns)
MAX_THREADS = 256
_CAPACITY = 2048  # variables a recording may hold
_HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "bls_miller_schedule.cuh")


# -- recording -----------------------------------------------------------------


class _Recording:
    """limbs.mul and limbs.renorm on coefficient vectors: each output row
    of either becomes a new variable, as the unit vector of its id."""

    def __init__(self, n_inputs: int):
        self.n_inputs = n_inputs
        self.ops = []  # (kind, forms): variable n_inputs + index

    def _new(self, kind: int, *forms) -> int:
        var = self.n_inputs + len(self.ops)
        if var >= _CAPACITY:
            raise RuntimeError(f"a recording holds at most {_CAPACITY} "
                               "variables")
        self.ops.append((kind, forms))
        return var

    @staticmethod
    def _form(row: torch.Tensor) -> tuple:
        return tuple((int(v), int(row[v])) for v in torch.nonzero(row)[:, 0])

    def mul(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        out = torch.zeros(a.shape, dtype=torch.int64)
        rows_a, rows_b = a.reshape(-1, _CAPACITY), b.reshape(-1, _CAPACITY)
        rows = out.view(-1, _CAPACITY)
        for i in range(rows.shape[0]):
            rows[i, self._new(MUL, self._form(rows_a[i]),
                              self._form(rows_b[i]))] = 1
        return out

    def renorm(self, a):
        out = torch.zeros(a.shape, dtype=torch.int64)
        rows, src = out.view(-1, _CAPACITY), a.reshape(-1, _CAPACITY)
        for i in range(rows.shape[0]):
            form = self._form(src[i])
            if len(form) == 1 and form[0][1] == 1 and form[0][0] >= self.n_inputs:
                rows[i] = src[i]  # a product or a renorm: canonical already
            else:
                rows[i, self._new(RENORM, form)] = 1
        return out


@contextlib.contextmanager
def _recorder(n_inputs: int):
    rec = _Recording(n_inputs)
    saved = limbs.mul, limbs.renorm
    limbs.mul, limbs.renorm = rec.mul, rec.renorm
    try:
        yield rec
    finally:
        limbs.mul, limbs.renorm = saved


def _units(ids, shape) -> torch.Tensor:
    t = torch.zeros(tuple(shape) + (_CAPACITY,), dtype=torch.int64)
    rows = t.view(-1, _CAPACITY)
    for row, var in enumerate(ids):
        rows[row, var] = 1
    return t


def _rows(t: torch.Tensor) -> list:
    return [_Recording._form(r) for r in t.reshape(-1, _CAPACITY)]


def dbl_slots(K: int) -> dict:
    """The doubling step's state slots: f's 12 coefficients (w-slot, then
    c0/c1), then for pair k the 8 slots from 12 + 8k: X, Y, Z (c0, c1
    each), px, py."""
    base = [F_SLOTS + PAIR_SLOTS * k for k in range(K)]
    return {"f": list(range(F_SLOTS)),
            "X": [b + c for b in base for c in (0, 1)],
            "Y": [b + 2 + c for b in base for c in (0, 1)],
            "Z": [b + 4 + c for b in base for c in (0, 1)],
            "px": [b + 6 for b in base], "py": [b + 7 for b in base]}


def _record(table: int):
    """(n_state, ops, outputs) of one step: ``outputs`` maps each state
    slot to the form of its new value."""
    if table == SQ:
        with _recorder(F_SLOTS) as rec:
            f = tower.fq12_square(_units(range(F_SLOTS), (6, 2)))
        return F_SLOTS, rec.ops, dict(enumerate(_rows(f)))
    K = table
    slots = dbl_slots(K)
    n_state = F_SLOTS + PAIR_SLOTS * K
    with _recorder(n_state) as rec:
        f, X, Y, Z = pairing._dbl_run_step(
            _units(slots["f"], (6, 2)), _units(slots["X"], (K, 2)),
            _units(slots["Y"], (K, 2)), _units(slots["Z"], (K, 2)),
            _units(slots["px"], (K,)), _units(slots["py"], (K,)))
    outputs = {}
    for name, t in (("f", f), ("X", X), ("Y", Y), ("Z", Z)):
        outputs.update(zip(slots[name], _rows(t)))
    return n_state, rec.ops, outputs


# -- scheduling ------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One step as the kernels run it.  ``phases`` [P, 3]: first op, MULs,
    RENORMs (the MULs first); ``ops`` [N, 4]: out slot, then the term
    ranges a = [1], [2]) and b = [2], [3]) of a MUL, or c = [1], [3]) of a
    RENORM; ``terms``: slot << 16 | coefficient (16-bit, signed)."""

    n_state: int
    n_slots: int
    threads: int
    phases: np.ndarray
    ops: np.ndarray
    terms: np.ndarray

    @property
    def products(self) -> int:
        return int(self.phases[:, 1].sum())


def _vars(form) -> list:
    return [v for v, _ in form]


def build(table: int) -> Schedule:
    """The schedule of ``table``: SQ, or the doubling step at K pairs."""
    n_state, recorded, outputs = _record(table)
    # the step's operations: (kind, forms, out variable)
    ops = [(kind, forms, n_state + i) for i, (kind, forms) in enumerate(recorded)]
    defined = {var: i for i, (_, _, var) in enumerate(ops)}
    # each output is a product or a renorm (in K4 and K5 all are renorms),
    # written over its state slot
    home = {}
    for slot, form in outputs.items():
        if not (len(form) == 1 and form[0][1] == 1 and form[0][0] in defined
                and form[0][0] not in home):
            raise ValueError(f"output slot {slot} is not a product or a "
                             f"renorm of its own: {form}")
        home[form[0][0]] = slot
    # the operations the outputs need
    needed, todo = set(), [defined[v] for v in home]
    while todo:
        i = todo.pop()
        if i in needed:
            continue
        needed.add(i)
        todo.extend(defined[v] for form in ops[i][1] for v in _vars(form)
                    if v in defined)
    order = sorted(needed)
    # phases: as soon as the operands exist
    phase = {}
    for i in order:
        phase[i] = max([phase[defined[v]] + 1 for form in ops[i][1]
                        for v in _vars(form) if v in defined], default=0)
    last_read = {}  # variable -> the last phase reading it
    for i in order:
        for form in ops[i][1]:
            for v in _vars(form):
                last_read[v] = max(last_read.get(v, -1), phase[i])
    for var, slot in home.items():
        if last_read.get(slot, -1) >= phase[defined[var]]:
            raise ValueError(f"output slot {slot} is still read in the phase "
                             "that writes it")
    # slots: inputs first, then a free list, each variable's slot reused
    # from the phase after its last read
    slot_of = {v: v for v in range(n_state)}
    slot_of.update(home)
    free, n_slots, live = [], n_state, []
    n_phases = max(phase.values()) + 1
    for p in range(n_phases):
        for var in [v for v in live if last_read[v] < p]:
            live.remove(var)
            free.append(slot_of[var])
        free.sort()
        for i in order:
            out = ops[i][2]
            if phase[i] != p or out in home:
                continue
            if free:
                slot_of[out] = free.pop(0)
            else:
                slot_of[out] = n_slots
                n_slots += 1
            live.append(out)
    # encode: by phase, the MULs first
    phases, enc_ops, terms = [], [], []

    def emit(form):
        for v, c in form:
            if not (-(1 << 15) <= c < (1 << 15)):
                raise ValueError(f"coefficient {c} does not fit 16 bits")
            terms.append((slot_of[v] << 16) | (c & 0xFFFF))
        return len(terms)

    for p in range(n_phases):
        here = [i for i in order if phase[i] == p]
        muls = [i for i in here if ops[i][0] == MUL]
        rest = [i for i in here if ops[i][0] != MUL]
        phases.append((len(enc_ops), len(muls), len(rest)))
        for i in muls + rest:
            kind, forms, out = ops[i]
            start = len(terms)
            mid = emit(forms[0])
            end = emit(forms[1]) if kind == MUL else mid
            enc_ops.append((slot_of[out], start, mid, end))
    widest = max(32 * -(-m // 32) + r for _, m, r in phases)
    threads = min(MAX_THREADS, 32 * -(-widest // 32))
    return Schedule(n_state=n_state, n_slots=n_slots, threads=threads,
                    phases=np.array(phases, dtype=np.int32),
                    ops=np.array(enc_ops, dtype=np.int32),
                    terms=np.array(terms, dtype=np.int64).astype(np.int32))


TABLES = (SQ, 1, 2, 3, 4)  # the squaring, then K = 1 .. pairing.MAX_PAIRS


def build_all() -> list:
    assert TABLES[-1] == pairing.MAX_PAIRS
    return [build(t) for t in TABLES]


def check(s: Schedule) -> None:
    """The hazards a phase must not have, since its operations run at
    once: two writing one slot, or one writing a slot another reads."""
    for first, n_mul, n_rest in s.phases:
        written, read = set(), set()
        for slot, a, mid, end in s.ops[first:first + n_mul + n_rest]:
            slot = int(slot)
            if slot in written:
                raise AssertionError(f"slot {slot} written twice in a phase")
            written.add(slot)
            read.update(int(w) >> 16 for w in s.terms[a:end])
        if written & read:
            raise AssertionError(f"slots {sorted(written & read)} written and "
                                 "read in one phase")


# -- the plain run of a table ----------------------------------------------------


def _matrix(s: Schedule, rows) -> torch.Tensor:
    m = torch.zeros((len(rows), s.n_slots), dtype=torch.int64)
    for r, (a, b) in enumerate(rows):
        for w in s.terms[a:b]:
            m[r, int(w) >> 16] += int(np.int16(w & 0xFFFF))
    return m


def _combine(m: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[M, n_slots] coefficients x [B, n_slots, 16] limbs -> [B, M, 16]."""
    return (m[None, :, :, None] * slots[:, None, :, :]).sum(dim=2)


def run_plain(s: Schedule, state: torch.Tensor, n: int) -> torch.Tensor:
    """n steps of the table in torch on ``state`` [B, n_state, 16]: each
    phase reads all its operands, then writes all its results, as the
    kernel's threads do between two barriers (``check`` rules out the
    rest).  Raises if a MUL operand has a limb that is not a signed 32-bit
    word, the kernel's product reads only the low word of each limb."""
    B = state.shape[0]
    slots = torch.zeros((B, s.n_slots, limbs.N_LIMBS), dtype=torch.int64)
    slots[:, :s.n_state] = state
    plan = []
    for first, n_mul, n_rest in s.phases:
        mul_ops = s.ops[first:first + n_mul]
        rest = s.ops[first + n_mul:first + n_mul + n_rest]
        plan.append((
            _matrix(s, [(o[1], o[2]) for o in mul_ops]),
            _matrix(s, [(o[2], o[3]) for o in mul_ops]),
            torch.as_tensor(mul_ops[:, 0], dtype=torch.int64),
            _matrix(s, [(o[1], o[3]) for o in rest]),
            torch.as_tensor(rest[:, 0], dtype=torch.int64)))
    for _ in range(n):
        for ma, mb, mul_out, mc, rest_out in plan:
            a, b, c = (_combine(m, slots) for m in (ma, mb, mc))
            if len(mul_out):
                if max(int(a.abs().max()), int(b.abs().max())) >= 1 << 31:
                    raise AssertionError("a product's operand limb is not a "
                                         "32-bit word")
                slots[:, mul_out] = limbs.mul_plain(a, b)
            slots[:, rest_out] = limbs.renorm(c)
    return slots[:, :s.n_state]


def pack_dbl(f, X, Y, Z, px, py) -> torch.Tensor:
    """The doubling state as slots [B, 12 + 8K, 16] (``dbl_slots``)."""
    K, B = px.shape[0], px.shape[1]
    pairs = torch.cat([X.permute(1, 0, 2, 3), Y.permute(1, 0, 2, 3),
                       Z.permute(1, 0, 2, 3), px.permute(1, 0, 2)[:, :, None],
                       py.permute(1, 0, 2)[:, :, None]], dim=2)
    return torch.cat([f.reshape(B, F_SLOTS, -1),
                      pairs.reshape(B, PAIR_SLOTS * K, -1)], dim=1)


def unpack_dbl(state: torch.Tensor, K: int):
    """(f, X, Y, Z) of a doubling state."""
    B = state.shape[0]
    f = state[:, :F_SLOTS].reshape(B, 6, 2, -1)
    pairs = state[:, F_SLOTS:].reshape(B, K, PAIR_SLOTS, -1).permute(1, 0, 2, 3)
    return (f, pairs[:, :, 0:2].contiguous(), pairs[:, :, 2:4].contiguous(),
            pairs[:, :, 4:6].contiguous())


# -- the header ------------------------------------------------------------------


def _array(name: str, values) -> str:
    values = [int(v) for v in np.asarray(values).reshape(-1)]
    lines = [", ".join(str(v) for v in values[i:i + 12])
             for i in range(0, len(values), 12)]
    return (f"__device__ __align__(16) const int {name}[{len(values)}] = {{\n    "
            + ",\n    ".join(lines) + "};\n")


def render(schedules) -> str:
    names = ["kSq"] + [f"kDbl{k}" for k in TABLES[1:]]
    out = [
        "// The schedules of K4 and K5: generated by `python -m",
        "// consensus_specs_tpu_torch.ops.bls.schedule` from the torch formulas",
        "// (ops/bls/pairing.py _dbl_run_step, ops/bls/tower.py fq12_square);",
        "// do not edit.  Table 0 is one Fq12 squaring, table k one Miller",
        "// doubling step at k pairs.  Per table: phases [P][3] (first op, MULs,",
        "// RENORMs, the MULs first); ops [N][4] (out slot, then the term ranges:",
        "// a MUL's a = [1], [2]) and b = [2], [3]), a RENORM's c = [1], [3]));",
        "// terms (slot << 16 | 16-bit signed coefficient).",
        "#pragma once",
        "",
        "namespace bls_schedule {",
        "",
        f"constexpr int kTables = {len(schedules)};",
    ]
    for field in ("n_state", "n_slots", "threads"):
        camel = "".join(w.capitalize() for w in field.split("_"))
        out.append(f"constexpr int k{camel}[kTables] = {{"
                   + ", ".join(str(getattr(s, field)) for s in schedules) + "};")
    out.append("constexpr int kMaxThreads = %d;" % MAX_THREADS)
    out.append("constexpr int kPhases[kTables] = {"
               + ", ".join(str(len(s.phases)) for s in schedules) + "};")
    out.append("constexpr int kOps[kTables] = {"
               + ", ".join(str(len(s.ops)) for s in schedules) + "};")
    out.append("constexpr int kTerms[kTables] = {"
               + ", ".join(str(len(s.terms)) for s in schedules) + "};")
    out.append("")
    for name, s in zip(names, schedules):
        out.append(_array(f"{name}Phases", s.phases))
        out.append(_array(f"{name}Ops", s.ops))
        out.append(_array(f"{name}Terms", s.terms))
    out.append("// table t's arrays")
    out.append("__device__ __forceinline__ void table(int t, const int*& phases,")
    out.append("                                      const int*& ops, const int*& terms) {")
    out.append("  switch (t) {")
    for t, name in enumerate(names):
        out.append(f"    {'default' if t == len(names) - 1 else f'case {t}'}: "
                   f"phases = {name}Phases; ops = {name}Ops; terms = {name}Terms; "
                   "return;")
    out += ["  }", "}", "", "}  // namespace bls_schedule", ""]
    return "\n".join(out)


def main() -> int:
    schedules = build_all()
    for s in schedules:
        check(s)
    with open(_HEADER, "w") as f:
        f.write(render(schedules))
    for t, s in zip(TABLES, schedules):
        print(f"table {t}: {len(s.phases)} phases, {s.products} products, "
              f"{len(s.ops)} ops, {len(s.terms)} terms, {s.n_slots} slots, "
              f"{s.threads} threads", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
