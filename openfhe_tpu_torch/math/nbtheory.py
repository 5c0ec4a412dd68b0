"""Host-side number theory for parameter generation.

A verbatim copy of `openfhe_tpu/math/nbtheory.py`, so the port never
imports the JAX package. Its seeded `random.Random` makes the prime and
root search deterministic, so both packages pick the same moduli and the
same 2N-th roots. Reference analog: OpenFHE's math/nbtheory.h and
lib/math/nbtheory2.cpp: Miller-Rabin primality, NTT-friendly prime search
(FirstPrime / NextPrime / PreviousPrime), roots of unity, and cyclotomic
helpers. Parameter generation is a one-time host step, so plain Python
ints (arbitrary precision) replace the reference's BigInteger backends.
"""

from __future__ import annotations

import math
import random

_MR_BASES_64 = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int, rounds: int = 40) -> bool:
    """Miller-Rabin primality test (deterministic below 3.3e24, else probabilistic)."""
    if n < 2:
        return False
    for p in _MR_BASES_64:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1

    def witness(a: int) -> bool:
        x = pow(a, d, n)
        if x in (1, n - 1):
            return False
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                return False
        return True

    if n < 3317044064679887385961981:
        return not any(witness(a) for a in _MR_BASES_64)
    rng = random.Random(0xC0FFEE ^ n)
    return not any(witness(rng.randrange(2, n - 1)) for _ in range(rounds))


def _factorize(n: int) -> dict[int, int]:
    """Full integer factorization via trial division + Pollard rho."""
    factors: dict[int, int] = {}

    def add(p: int) -> None:
        factors[p] = factors.get(p, 0) + 1

    def rho(m: int) -> int:
        if m % 2 == 0:
            return 2
        rng = random.Random(m)
        while True:
            x = rng.randrange(2, m)
            y, c, d = x, rng.randrange(1, m), 1
            while d == 1:
                x = (x * x + c) % m
                y = (y * y + c) % m
                y = (y * y + c) % m
                d = math.gcd(abs(x - y), m)
            if d != m:
                return d

    def rec(m: int) -> None:
        if m == 1:
            return
        if is_prime(m):
            add(m)
            return
        d = rho(m)
        rec(d)
        rec(m // d)

    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            add(p)
            n //= p
    rec(n)
    return factors


def is_primitive_root(g: int, order: int, modulus: int) -> bool:
    if pow(g, order, modulus) != 1:
        return False
    return all(pow(g, order // p, modulus) != 1 for p in _factorize(order))


def root_of_unity(order: int, modulus: int) -> int:
    """Smallest-search primitive `order`-th root of unity mod prime `modulus`.

    Reference analog: RootOfUnity (nbtheory-impl.h). Requires
    order | (modulus - 1). Deterministic for a given (order, modulus).
    """
    if (modulus - 1) % order != 0:
        raise ValueError(f"{order} does not divide {modulus}-1")
    cofactor = (modulus - 1) // order
    rng = random.Random(modulus * 0x9E3779B97F4A7C15 + order)
    for _ in range(10000):
        g = rng.randrange(2, modulus)
        cand = pow(g, cofactor, modulus)
        if cand != 1 and is_primitive_root(cand, order, modulus):
            return cand
    raise RuntimeError(f"no {order}-th root of unity found mod {modulus}")


def first_prime(n_bits: int, order: int) -> int:
    """Smallest prime >= 2^(n_bits-1)... of the form k*order + 1 near 2^n_bits.

    Matches the reference's FirstPrime semantics: the first prime q with
    q = 1 (mod order) greater than or equal to 2^n_bits... we return the
    smallest such prime >= 2^(n_bits) is too big for n_bits-sized moduli, so
    (like nbtheory-impl.h FirstPrime) we start at the first candidate above
    2^(n_bits-1) ... Here: smallest prime == 1 mod order with exactly n_bits
    bits (i.e. in [2^(n_bits-1), 2^n_bits)), ascending.
    """
    lo = 1 << (n_bits - 1)
    q = lo + 1
    rem = (q - 1) % order
    if rem:
        q += order - rem
    while q < (1 << n_bits):
        if is_prime(q):
            return q
        q += order
    raise RuntimeError(f"no {n_bits}-bit prime = 1 mod {order}")


def next_prime(q: int, order: int) -> int:
    """Next prime > q congruent to 1 mod order (reference: NextPrime)."""
    c = q + order - ((q - 1) % order)
    while not is_prime(c):
        c += order
    return c


def previous_prime(q: int, order: int) -> int:
    """Largest prime < q congruent to 1 mod order (reference: PreviousPrime)."""
    c = q - ((q - 1) % order or order)
    while c > order and not is_prime(c):
        c -= order
    if c <= order:
        raise RuntimeError("ran out of primes going down")
    return c


def bit_reverse(x: int, n_bits: int) -> int:
    r = 0
    for _ in range(n_bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def totient(n: int) -> int:
    result = n
    for p in _factorize(n):
        result -= result // p
    return result


def find_generator_cyclic(modulus: int) -> int:
    """Generator of Z_modulus^* for prime modulus (reference: FindGeneratorCyclic)."""
    order = modulus - 1
    rng = random.Random(modulus)
    for _ in range(10000):
        g = rng.randrange(2, modulus)
        if is_primitive_root(g, order, modulus):
            return g
    raise RuntimeError("no generator found")


def mod_inverse(a: int, m: int) -> int:
    return pow(a, -1, m)
