# Data Availability Sampling executable spec (transcribes
# specs/das/das-core.md of the reference snapshot; builds on sharding).
#
# Polynomial machinery (NTT over the BLS scalar field, erasure recovery)
# lives in crypto/fr.py; the spec functions here are the das-core
# pipeline: extension, sampling, verification, reconstruction.  The md
# leaves recover_data / multi-proof internals as "...": this framework
# implements them (zero-poly erasure recovery; FK20-style multi-proofs
# are represented by per-sample KZG commitments over the sample domain).
#
# das/fork-choice.md's dependency-calculation blocks are NOT transcribed:
# they reference a pre-snapshot sharding state layout
# (current_epoch_pending_headers) that no longer exists in
# sharding/beacon-chain.md, and one comprehension is syntactically
# invalid — the reference never compiled that document either.

SampleIndex = uint64


class DASSample(Container):
    slot: Slot
    shard: Shard
    index: SampleIndex
    proof: BLSCommitment
    data: Vector[BLSPoint, POINTS_PER_SAMPLE]


# Reverse bit ordering (das-core.md:62-81)
def is_power_of_two(value: int) -> bool:
    return value > 0 and (value & (value - 1) == 0)


def reverse_bit_order(n: int, order: int):
    """
    Reverse the bit order of an integer n
    """
    assert is_power_of_two(order)
    return int(('{:0' + str(order.bit_length() - 1) + 'b}').format(n)[::-1], 2)


def reverse_bit_order_list(elements: Sequence[int]) -> Sequence[int]:
    order = len(elements)
    assert is_power_of_two(order)
    return [elements[reverse_bit_order(i, order)] for i in range(order)]


# Data extension (das-core.md:85-99)
def fft(values: Sequence[int]) -> Sequence[int]:
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.fft(list(values))


def inverse_fft(values: Sequence[int]) -> Sequence[int]:
    from consensus_specs_tpu_torch.crypto import fr as _fr

    return _fr.ifft(list(values))


def das_fft_extension(data: Sequence[int]) -> Sequence[int]:
    """
    Given some even-index values of an IFFT input, compute the odd-index inputs,
    such that the second output half of the IFFT is all zeroes.
    """
    poly = inverse_fft(data)
    return fft(list(poly) + [0] * len(poly))[1::2]


# Data recovery (das-core.md:101-115)
def recover_data(data: Sequence) -> Sequence[int]:
    """Given a subset of half or more of subgroup-aligned ranges of values,
    recover the None values."""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    flat = []
    chunk_len = None
    for chunk in data:
        if chunk is not None:
            chunk_len = len(chunk)
    assert chunk_len is not None, "at least one sample subgroup required"
    for chunk in data:
        if chunk is None:
            flat.extend([None] * chunk_len)
        else:
            flat.extend(chunk)
    return _fr.recover_polynomial(flat)


# DAS functions (das-core.md:117-190)
def extend_data(data: Sequence[int]) -> Sequence[int]:
    """
    The input data gets reverse-bit-ordered, such that the first half of the final output matches the original data.
    We calculated the odd-index values with the DAS FFT extension, reverse-bit-order to put them in the second half.
    """
    rev_bit_odds = reverse_bit_order_list(das_fft_extension(reverse_bit_order_list(data)))
    return list(data) + list(rev_bit_odds)


def unextend_data(extended_data: Sequence[int]) -> Sequence[int]:
    return extended_data[:len(extended_data) // 2]


def _coset_interpolation(x: int, ys: Sequence[int]) -> Sequence[int]:
    """Coefficients of the polynomial matching ``ys`` on the coset
    x * <h>, h an order-len(ys) root of unity (ys in coset order:
    ys[m] = value at x * h^m)."""
    from consensus_specs_tpu_torch.crypto import fr as _fr

    coeffs = _fr.ifft(list(ys))
    x_inv = pow(int(x), _fr.R - 2, _fr.R)
    x_inv_pow = 1
    out = []
    for c in coeffs:
        out.append(c * x_inv_pow % _fr.R)
        x_inv_pow = x_inv_pow * x_inv % _fr.R
    return out


def check_multi_kzg_proof(commitment: BLSCommitment, proof: BLSCommitment,
                          x: int, ys: Sequence[int]) -> bool:
    """
    Run a KZG multi-proof check to verify that for the subgroup starting at x,
    the proof indeed complements the ys to match the commitment:
        e(proof, [s^m - x^m]_2) == e(C - [I(s)]_1, H)
    with m = len(ys) and I the coset interpolation of ys.
    """
    from consensus_specs_tpu_torch.crypto import fr as _fr
    from consensus_specs_tpu_torch.crypto import kzg as _kzg
    from consensus_specs_tpu_torch.crypto.bls.curve import (
        g1_from_bytes,
        g2_generator,
    )

    m = len(ys)
    i_commit = _kzg.g1_lincomb(
        _kzg.setup_monomial(m), _coset_interpolation(x, ys))
    c_point = g1_from_bytes(bytes(commitment))
    proof_point = g1_from_bytes(bytes(proof))
    g2_setup = _kzg.setup_g2_monomial(m + 1)
    z_g2 = g2_setup[m] - g2_setup[0].mul(pow(int(x), m, _fr.R))
    lhs = bls.Pairing(proof_point, z_g2)
    rhs = bls.Pairing(c_point - i_commit, g2_generator())
    return lhs == rhs


def construct_proofs(extended_data_as_poly: Sequence[int]) -> Sequence[BLSCommitment]:
    """
    Constructs proofs for samples of extended data (in polynomial form, 2nd half being zeroes).
    Per-coset quotient commitments q_k = (P - I_k) / (X^m - x_k^m) — the
    FK20 batch construction computes the same quotients with shared FFTs.
    Proof order: coset index k (domain order).
    """
    from consensus_specs_tpu_torch.crypto import fr as _fr
    from consensus_specs_tpu_torch.crypto import kzg as _kzg
    from consensus_specs_tpu_torch.crypto.bls.curve import g1_to_bytes

    n = len(extended_data_as_poly)
    poly = [int(v) % _fr.R for v in extended_data_as_poly]
    evals = _fr.fft(poly)
    m = int(POINTS_PER_SAMPLE)
    sample_count = n // m
    w = _fr.root_of_unity(n)
    proofs = []
    for k in range(sample_count):
        x = pow(w, k, _fr.R)
        ys = [evals[k + j * sample_count] for j in range(m)]
        i_coeffs = list(_coset_interpolation(x, ys)) + [0] * (n - m)
        # numerator = P - I vanishes on the coset; divide by X^m - x^m
        num = [(p - i) % _fr.R for p, i in zip(poly, i_coeffs)]
        x_m = pow(x, m, _fr.R)
        quotient = [0] * (n - m)
        rem = list(num)
        for deg in range(n - 1, m - 1, -1):
            coef = rem[deg]
            if coef:
                quotient[deg - m] = coef
                rem[deg] = 0
                rem[deg - m] = (rem[deg - m] + coef * x_m) % _fr.R
        assert all(c == 0 for c in rem[:m]), "P - I not divisible by coset vanishing poly"
        proofs.append(BLSCommitment(g1_to_bytes(
            _kzg.g1_lincomb(_kzg.setup_monomial(len(quotient)), quotient))))
    return proofs


def sample_data(slot: Slot, shard: Shard, extended_data: Sequence[int]) -> Sequence[DASSample]:
    sample_count = len(extended_data) // int(POINTS_PER_SAMPLE)
    # get polynomial form of full extended data, second half will be all zeroes.
    poly = inverse_fft(reverse_bit_order_list([int(v) for v in extended_data]))
    assert all(v == 0 for v in poly[len(poly) // 2:])
    proofs = construct_proofs(poly)
    return [
        DASSample(
            slot=slot,
            shard=shard,
            index=i,
            # proofs are in coset (domain) order; chunk i covers coset
            # reverse_bit_order(i)
            proof=proofs[reverse_bit_order(i, sample_count)],
            data=extended_data[i * int(POINTS_PER_SAMPLE):(i + 1) * int(POINTS_PER_SAMPLE)],
        ) for i in range(sample_count)
    ]


def verify_sample(sample: DASSample, sample_count: uint64, commitment: BLSCommitment):
    from consensus_specs_tpu_torch.crypto import fr as _fr

    domain_pos = reverse_bit_order(int(sample.index), int(sample_count))
    n_points = int(sample_count) * int(POINTS_PER_SAMPLE)
    w = _fr.root_of_unity(n_points)
    x = pow(w, domain_pos, _fr.R)
    ys = reverse_bit_order_list([int(v) for v in sample.data])
    assert check_multi_kzg_proof(commitment, sample.proof, x, ys)


def reconstruct_extended_data(samples: Sequence) -> Sequence[int]:
    # Instead of recovering with a point-by-point approach, recover the
    # samples by recovering missing subgroups (cosets).  Chunk i covers
    # coset k = reverse_bit_order(i): domain positions k + j*sample_count,
    # with in-coset order the bit-reversal of the display order.  Returns
    # the full extended data back in display order.
    from consensus_specs_tpu_torch.crypto import fr as _fr

    sample_count = len(samples)
    m = int(POINTS_PER_SAMPLE)
    n = sample_count * m
    evals = [None] * n
    for i, sample in enumerate(samples):
        if sample is None:
            continue
        k = reverse_bit_order(i, sample_count)
        ys = reverse_bit_order_list([int(v) for v in sample.data])
        for j in range(m):
            evals[k + j * sample_count] = ys[j]
    recovered = _fr.recover_polynomial(evals)
    return reverse_bit_order_list(recovered)
