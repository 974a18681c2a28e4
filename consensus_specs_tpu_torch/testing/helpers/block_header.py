"""Header signing (parity surface: reference ``test/helpers/block_header.py``)."""
from consensus_specs_tpu_torch.crypto import bls


def sign_block_header(spec, state, header, privkey):
    domain = spec.get_domain(state, spec.DOMAIN_BEACON_PROPOSER)
    return spec.SignedBeaconBlockHeader(
        message=header,
        signature=bls.Sign(privkey, spec.compute_signing_root(header, domain)),
    )
