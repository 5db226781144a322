"""DVB-T2 outer BCH code (ETSI EN 302 755 clause 6.1, tables 6a/6b + Annex).

t=12-error-correcting BCH over GF(2^16) (normal FEC frames, 192 parity bits)
and GF(2^14) (short frames, 168 parity bits).  The generator polynomial is the
product of the minimal polynomials of alpha^1..alpha^(2t) and is built
algebraically from the standard's g1(x) primitive polynomial.

This *exceeds* the reference receiver, whose BCH stage is a stub
(`reference/src/DVB_T2/bch_decoder.cpp:136` "// TODO BCH decode" --
descrambling only).  Decode = syndromes + Berlekamp-Massey + Chien search,
vectorized with NumPy log/antilog tables; a fast all-zero-syndrome path makes
the common post-LDPC case (no residual errors) nearly free.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .params import FECFrame

# primitive polynomials of the BCH fields, from DVB-T2 table 7 g1(x):
#   normal: g1 = 1 + x^2 + x^3 + x^5 + x^16
#   short:  g1 = 1 + x + x^3 + x^5 + x^14
_FIELD_POLY = {FECFrame.NORMAL: (1 << 16) | 0b101101, FECFrame.SHORT: (1 << 14) | 0b101011}
_FIELD_BITS = {FECFrame.NORMAL: 16, FECFrame.SHORT: 14}


def t_errors(frame: FECFrame, k_bch: int, n_bch: int) -> int:
    """Error-correcting capability from table 6a/6b: t = parity / field bits.

    Normal frames: t=12 except rates 2/3 and 5/6 (160 parity bits, t=10);
    short frames: always t=12 (168 parity bits over GF(2^14)).
    """
    t, rem = divmod(n_bch - k_bch, _FIELD_BITS[frame])
    assert rem == 0
    return t


@dataclass(frozen=True, eq=False)
class BCHField:
    bits: int
    exp: np.ndarray   # (2*(2^bits),) antilog table (doubled to skip mod)
    log: np.ndarray   # (2^bits,) log table, log[0] = -1 sentinel
    gen_poly: int     # generator polynomial as big int, degree = parity bits
    parity: int
    crc_table: np.ndarray  # (256,) object array of python ints: byte-wise remainder


@functools.lru_cache(maxsize=None)
def field(frame: FECFrame, t: int = 12) -> BCHField:
    bits = _FIELD_BITS[frame]
    poly = _FIELD_POLY[frame]
    size = 1 << bits
    exp = np.zeros(2 * size, dtype=np.int64)
    log = np.full(size, -1, dtype=np.int64)
    x = 1
    for i in range(size - 1):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & size:
            x ^= poly
    exp[size - 1:2 * (size - 1)] = exp[:size - 1]

    # generator polynomial: lcm of minimal polys of alpha^1 .. alpha^{2t}
    def min_poly(power: int) -> int:
        # conjugacy class of alpha^power
        conj = set()
        p = power % (size - 1)
        while p not in conj:
            conj.add(p)
            p = (p * 2) % (size - 1)
        # poly = prod (x - alpha^c) over the class, computed in GF(2^bits)
        coeffs = [1]  # coefficients in GF, highest degree first
        for c in conj:
            root = exp[c]
            new = [0] * (len(coeffs) + 1)
            for i, a in enumerate(coeffs):
                new[i] ^= _gf_mul_int(a, root, log, exp, size)
                new[i + 1] ^= a
            coeffs = new
        # minimal poly has coefficients in GF(2) -> bitmask int (bit i = x^i)
        out = 0
        for i, a in enumerate(coeffs):
            assert a in (0, 1)
            out |= a << i
        return out

    gen = 1
    seen = set()
    for i in range(1, 2 * t + 1):
        p = i % (size - 1)
        # skip powers already covered by an earlier conjugacy class
        cls = frozenset(_conj_class(p, size))
        if cls in seen:
            continue
        seen.add(cls)
        gen = _poly_mul_gf2(gen, min_poly(i))
    parity = gen.bit_length() - 1

    # byte-wise remainder table for fast encoding (CRC-style over GF(2))
    mask = (1 << parity) - 1
    gen_low = gen & mask  # generator without its x^parity term
    crc_table = np.empty(256, dtype=object)
    for byte in range(256):
        t = byte << (parity - 8)
        for _ in range(8):
            top = t & (1 << (parity - 1))
            t = (t << 1) & mask
            if top:
                t ^= gen_low
        crc_table[byte] = t
    return BCHField(bits=bits, exp=exp, log=log, gen_poly=gen, parity=parity,
                    crc_table=crc_table)


def _conj_class(p: int, size: int):
    out = []
    seen = set()
    while p not in seen:
        seen.add(p)
        out.append(p)
        p = (p * 2) % (size - 1)
    return out


def _gf_mul_int(a: int, b: int, log, exp, size: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(exp[(log[a] + log[b]) % (size - 1)])


def _poly_mul_gf2(a: int, b: int) -> int:
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        b >>= 1
    return out


def encode(frame: FECFrame, info_bits: np.ndarray, t: int = 12) -> np.ndarray:
    """Systematic BCH encode: (..., K) bits -> (..., K + parity) bits."""
    f = field(frame, t)
    info_bits = np.asarray(info_bits, dtype=np.uint8)
    batch_shape = info_bits.shape[:-1]
    flat = info_bits.reshape(-1, info_bits.shape[-1])
    kbits = flat.shape[1]
    assert kbits % 8 == 0, "DVB-T2 k_bch is always byte aligned"
    data_bytes = np.packbits(flat, axis=1)
    out = np.empty((flat.shape[0], kbits + f.parity), dtype=np.uint8)
    mask = (1 << f.parity) - 1
    top_shift = f.parity - 8
    for b in range(flat.shape[0]):
        rem = 0
        for byte in data_bytes[b].tolist():
            idx = ((rem >> top_shift) & 0xFF) ^ byte
            rem = ((rem << 8) & mask) ^ f.crc_table[idx]
        out[b, :kbits] = flat[b]
        parity_bits = np.frombuffer(
            rem.to_bytes((f.parity + 7) // 8, "big"), dtype=np.uint8)
        out[b, kbits:] = np.unpackbits(parity_bits)[-f.parity:]
    return out.reshape(*batch_shape, kbits + f.parity)


def syndromes(frame: FECFrame, code_bits: np.ndarray, t: int = 12) -> np.ndarray:
    """Syndromes S_1..S_2t of one codeword ((N,) bits).  All-zero => clean."""
    f = field(frame, t)
    n = code_bits.shape[-1]
    # bit j of the codeword is the coefficient of x^(n-1-j)
    positions = np.nonzero(code_bits)[0]
    degs = (n - 1 - positions).astype(np.int64)
    size = 1 << f.bits
    out = np.zeros(2 * t, dtype=np.int64)
    for i in range(1, 2 * t + 1):
        out[i - 1] = np.bitwise_xor.reduce(f.exp[(i * degs) % (size - 1)]) \
            if len(degs) else 0
    return out


def decode(frame: FECFrame, code_bits: np.ndarray, t: int = 12) -> tuple[np.ndarray, int]:
    """Correct up to t bit errors in-place (copy).  Returns (bits, n_fixed);
    n_fixed = -1 when uncorrectable."""
    f = field(frame, t)
    bits = np.array(code_bits, dtype=np.uint8, copy=True)
    s = syndromes(frame, bits, t)
    if not s.any():
        return bits, 0
    size = 1 << f.bits
    log, exp = f.log, f.exp
    nn = size - 1

    def gmul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % nn])

    # Berlekamp-Massey over GF(2^bits)
    C = [1] + [0] * (2 * t)
    B = [1] + [0] * (2 * t)
    L, mlen, bcoef = 0, 1, 1
    for nidx in range(2 * t):
        d = int(s[nidx])
        for i in range(1, L + 1):
            d ^= gmul(C[i], int(s[nidx - i]))
        if d == 0:
            mlen += 1
        elif 2 * L <= nidx:
            T = C[:]
            coef = gmul(d, exp[(nn - log[bcoef]) % nn])
            for i in range(0, 2 * t + 1 - mlen):
                C[i + mlen] ^= gmul(coef, B[i])
            L = nidx + 1 - L
            B = T
            bcoef = d
            mlen = 1
        else:
            coef = gmul(d, exp[(nn - log[bcoef]) % nn])
            for i in range(0, 2 * t + 1 - mlen):
                C[i + mlen] ^= gmul(coef, B[i])
            mlen += 1
    if L > t:
        return bits, -1
    # Chien search, vectorized: roots of the locator are at alpha^{-deg},
    # so evaluate Lambda(alpha^{-deg}) for every candidate error degree.
    n = bits.shape[-1]
    degs = np.arange(n, dtype=np.int64)          # candidate error degree
    acc = np.full(n, C[0], dtype=np.int64)
    for i in range(1, L + 1):
        if C[i] == 0:
            continue
        acc ^= exp[(log[C[i]] + i * ((nn - degs) % nn)) % nn]
    err_degs = degs[acc == 0]
    if len(err_degs) != L:
        return bits, -1
    err_pos = n - 1 - err_degs
    bits[err_pos] ^= 1
    if syndromes(frame, bits, t).any():
        return bits, -1
    return bits, int(L)
