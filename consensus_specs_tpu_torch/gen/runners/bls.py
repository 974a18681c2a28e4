"""BLS vector generator (reference capability:
tests/generators/bls/main.py): sign / verify / aggregate /
fast_aggregate_verify / aggregate_verify / eth_aggregate_pubkeys /
eth_fast_aggregate_verify handlers, each case a data part
{input, output}, including the spec's edge cases (infinity points,
tampered signatures, out-of-subgroup bytes).
"""
from __future__ import annotations

from typing import Iterable

from consensus_specs_tpu_torch.crypto import bls as bls_sel
from consensus_specs_tpu_torch.crypto.bls import ciphersuite
from consensus_specs_tpu_torch.gen import gen_runner, gen_typing
from consensus_specs_tpu_torch.testing.context import spec_targets

G2_INFINITY = "0x" + (bytes([0xC0]) + b"\x00" * 95).hex()
G1_INFINITY = "0x" + (bytes([0xC0]) + b"\x00" * 47).hex()

PRIVKEYS = [
    0x00000000000000000000000000000000263DBD792F5B1BE47ED85F8938C0F29586AF0D3AC7B977F21C278FE1462040C3 % ciphersuite.R,
    0x0000000000000000000000000000000047B8192D77BF871B62E87859D653922725724A5C031AFEABC60BCEF5FF665138 % ciphersuite.R,
    0x00000000000000000000000000000000328388AFF0D4A5B7DC9205ABD374E7E98F3CD9F3418EDB4EAFDA5FB16473D216 % ciphersuite.R,
]
MESSAGES = [b"\x00" * 32, b"\x56" * 32, b"\xab" * 32]

_hex = lambda b: "0x" + bytes(b).hex()  # noqa: E731


def _sk_hex(sk: int) -> str:
    return "0x" + sk.to_bytes(32, "big").hex()


def case_sign() -> Iterable:
    for i, sk in enumerate(PRIVKEYS):
        for j, msg in enumerate(MESSAGES):
            sig = ciphersuite.Sign(sk, msg)
            yield f"sign_case_{i}_{j}", {
                "input": {"privkey": _sk_hex(sk), "message": _hex(msg)},
                "output": _hex(sig),
            }
    # edge: zero privkey is invalid
    yield "sign_case_zero_privkey", {
        "input": {"privkey": _sk_hex(0), "message": _hex(MESSAGES[0])},
        "output": None,
    }


def case_verify() -> Iterable:
    sk, msg = PRIVKEYS[0], MESSAGES[0]
    pk = ciphersuite.SkToPk(sk)
    sig = ciphersuite.Sign(sk, msg)
    yield "verify_valid", {
        "input": {"pubkey": _hex(pk), "message": _hex(msg), "signature": _hex(sig)},
        "output": True,
    }
    yield "verify_wrong_message", {
        "input": {"pubkey": _hex(pk), "message": _hex(MESSAGES[1]), "signature": _hex(sig)},
        "output": False,
    }
    wrong_pk = ciphersuite.SkToPk(PRIVKEYS[1])
    yield "verify_wrong_pubkey", {
        "input": {"pubkey": _hex(wrong_pk), "message": _hex(msg), "signature": _hex(sig)},
        "output": False,
    }
    yield "verify_infinity_signature", {
        "input": {"pubkey": _hex(pk), "message": _hex(msg), "signature": G2_INFINITY},
        "output": False,
    }
    yield "verify_infinity_pubkey_and_infinity_signature", {
        "input": {"pubkey": G1_INFINITY, "message": _hex(msg), "signature": G2_INFINITY},
        "output": False,
    }
    tampered = bytes(sig[:-4]) + b"\xff\xff\xff\xff"
    yield "verify_tampered_signature", {
        "input": {"pubkey": _hex(pk), "message": _hex(msg), "signature": _hex(tampered)},
        "output": False,
    }


def case_aggregate() -> Iterable:
    sigs = [ciphersuite.Sign(sk, MESSAGES[0]) for sk in PRIVKEYS]
    yield "aggregate_some_signatures", {
        "input": [_hex(s) for s in sigs],
        "output": _hex(ciphersuite.Aggregate(sigs)),
    }
    yield "aggregate_single_signature", {
        "input": [_hex(sigs[0])],
        "output": _hex(ciphersuite.Aggregate(sigs[:1])),
    }
    yield "aggregate_na_signatures", {"input": [], "output": None}
    yield "aggregate_infinity_signature", {
        "input": [G2_INFINITY],
        "output": G2_INFINITY,
    }


def case_fast_aggregate_verify() -> Iterable:
    msg = MESSAGES[1]
    pks = [ciphersuite.SkToPk(sk) for sk in PRIVKEYS]
    agg = ciphersuite.Aggregate([ciphersuite.Sign(sk, msg) for sk in PRIVKEYS])
    yield "fast_aggregate_verify_valid", {
        "input": {"pubkeys": [_hex(p) for p in pks], "message": _hex(msg),
                  "signature": _hex(agg)},
        "output": True,
    }
    yield "fast_aggregate_verify_extra_pubkey", {
        "input": {"pubkeys": [_hex(p) for p in pks] + [_hex(pks[0])],
                  "message": _hex(msg), "signature": _hex(agg)},
        "output": False,
    }
    yield "fast_aggregate_verify_na_pubkeys_and_infinity_signature", {
        "input": {"pubkeys": [], "message": _hex(msg), "signature": G2_INFINITY},
        "output": False,
    }
    yield "fast_aggregate_verify_infinity_pubkey", {
        "input": {"pubkeys": [_hex(pks[0]), G1_INFINITY], "message": _hex(msg),
                  "signature": _hex(agg)},
        "output": False,
    }


def case_aggregate_verify() -> Iterable:
    pks = [ciphersuite.SkToPk(sk) for sk in PRIVKEYS]
    sigs = [ciphersuite.Sign(sk, m) for sk, m in zip(PRIVKEYS, MESSAGES)]
    agg = ciphersuite.Aggregate(sigs)
    yield "aggregate_verify_valid", {
        "input": {"pubkeys": [_hex(p) for p in pks],
                  "messages": [_hex(m) for m in MESSAGES],
                  "signature": _hex(agg)},
        "output": True,
    }
    yield "aggregate_verify_tampered_signature", {
        "input": {"pubkeys": [_hex(p) for p in pks],
                  "messages": [_hex(m) for m in MESSAGES],
                  "signature": _hex(bytes(agg[:-4]) + b"\x00" * 4)},
        "output": False,
    }
    yield "aggregate_verify_na_pubkeys_and_infinity_signature", {
        "input": {"pubkeys": [], "messages": [], "signature": G2_INFINITY},
        "output": False,
    }


def case_eth_aggregate_pubkeys(spec) -> Iterable:
    pks = [ciphersuite.SkToPk(sk) for sk in PRIVKEYS]
    yield "eth_aggregate_pubkeys_valid", {
        "input": [_hex(p) for p in pks],
        "output": _hex(spec.eth_aggregate_pubkeys([spec.BLSPubkey(p) for p in pks])),
    }
    yield "eth_aggregate_pubkeys_empty_list", {"input": [], "output": None}
    yield "eth_aggregate_pubkeys_infinity_pubkey", {
        "input": [G1_INFINITY], "output": None,
    }


def case_eth_fast_aggregate_verify(spec) -> Iterable:
    msg = MESSAGES[2]
    pks = [ciphersuite.SkToPk(sk) for sk in PRIVKEYS]
    agg = ciphersuite.Aggregate([ciphersuite.Sign(sk, msg) for sk in PRIVKEYS])
    yield "eth_fast_aggregate_verify_valid", {
        "input": {"pubkeys": [_hex(p) for p in pks], "message": _hex(msg),
                  "signature": _hex(agg)},
        "output": True,
    }
    # altair divergence from the IETF suite: empty keys + infinity sig is VALID
    yield "eth_fast_aggregate_verify_na_pubkeys_and_infinity_signature", {
        "input": {"pubkeys": [], "message": _hex(msg), "signature": G2_INFINITY},
        "output": True,
    }
    yield "eth_fast_aggregate_verify_wrong_message", {
        "input": {"pubkeys": [_hex(p) for p in pks], "message": _hex(MESSAGES[0]),
                  "signature": _hex(agg)},
        "output": False,
    }


def create_provider(fork_name: str, handler_name: str, case_maker) -> gen_typing.TestProvider:
    def prepare_fn() -> None:
        bls_sel.use_fastest()

    def cases_fn() -> Iterable[gen_typing.TestCase]:
        for case_name, case_content in case_maker():
            yield gen_typing.TestCase(
                fork_name=fork_name,
                preset_name="general",
                runner_name="bls",
                handler_name=handler_name,
                suite_name="bls",
                case_name=case_name,
                case_fn=(lambda c=case_content: iter([("data", "data", c)])),
            )

    return gen_typing.TestProvider(prepare=prepare_fn, make_cases=cases_fn)


def main(argv=None, device=None):
    # the altair spec is built when its cases are made, inside the run, on
    # the run's device
    def altair_spec():
        return spec_targets["minimal"]["altair"]

    return gen_runner.run_generator("bls", [
        create_provider("phase0", "sign", case_sign),
        create_provider("phase0", "verify", case_verify),
        create_provider("phase0", "aggregate", case_aggregate),
        create_provider("phase0", "fast_aggregate_verify", case_fast_aggregate_verify),
        create_provider("phase0", "aggregate_verify", case_aggregate_verify),
        create_provider("altair", "eth_aggregate_pubkeys",
                        lambda: case_eth_aggregate_pubkeys(altair_spec())),
        create_provider("altair", "eth_fast_aggregate_verify",
                        lambda: case_eth_fast_aggregate_verify(altair_spec())),
    ], argv=argv, device=device)


if __name__ == "__main__":
    main()
