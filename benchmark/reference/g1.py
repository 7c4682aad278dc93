"""G1 of BLS12-377, y^2 = x^3 + 1 over Fq, in Jacobian coordinates over
Python integers, with arkworks' compressed encoding."""

from __future__ import annotations

from .field import Q

#: the standard generator of G1 (arkworks' G1_GENERATOR_X, _Y)
GENERATOR_X = 81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695
GENERATOR_Y = 241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030
#: points are (X, Y, Z) with x = X/Z^2, y = Y/Z^3; Z = 0 is the identity
IDENTITY = (1, 1, 0)
GENERATOR = (GENERATOR_X, GENERATOR_Y, 1)
assert (GENERATOR_Y * GENERATOR_Y - GENERATOR_X**3 - 1) % Q == 0


def double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return IDENTITY
    a = X * X % Q
    b = Y * Y % Q
    c = b * b % Q
    d = 2 * ((X + b) * (X + b) - a - c) % Q
    e = 3 * a % Q
    x3 = (e * e - 2 * d) % Q
    y3 = (e * (d - x3) - 8 * c) % Q
    z3 = 2 * Y * Z % Q
    return (x3, y3, z3)


def add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    z1z1 = Z1 * Z1 % Q
    z2z2 = Z2 * Z2 % Q
    u1 = X1 * z2z2 % Q
    u2 = X2 * z1z1 % Q
    s1 = Y1 * Z2 % Q * z2z2 % Q
    s2 = Y2 * Z1 % Q * z1z1 % Q
    if u1 == u2:
        return double(p) if s1 == s2 else IDENTITY
    h = (u2 - u1) % Q
    i = 4 * h * h % Q
    j = h * i % Q
    r = 2 * (s2 - s1) % Q
    v = u1 * i % Q
    x3 = (r * r - j - 2 * v) % Q
    y3 = (r * (v - x3) - 2 * s1 * j) % Q
    z3 = ((Z1 + Z2) * (Z1 + Z2) - z1z1 - z2z2) * h % Q
    return (x3, y3, z3)


def neg(p):
    X, Y, Z = p
    return (X, (-Y) % Q, Z)


def mul(k: int, p):
    """k * p for k >= 0, four bits at a time."""
    if k == 0 or p[2] == 0:
        return IDENTITY
    table = [IDENTITY, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    acc = IDENTITY
    for shift in range((k.bit_length() + 3) // 4 * 4 - 4, -1, -4):
        if acc[2]:
            acc = double(double(double(double(acc))))
        digit = (k >> shift) & 15
        if digit:
            acc = add(acc, table[digit])
    return acc


def affine(p):
    """(x, y), or None for the identity."""
    X, Y, Z = p
    if Z % Q == 0:
        return None
    zinv = pow(Z, -1, Q)
    z2 = zinv * zinv % Q
    return (X * z2 % Q, Y * z2 % Q * zinv % Q)


def equal(p, q) -> bool:
    return affine(p) == affine(q)


def compress(p) -> bytes:
    """arkworks' compressed G1 encoding: x in 48 little-endian bytes, 0x80
    on the last byte when y is the larger of y and -y, the identity as zero
    with 0x40."""
    a = affine(p)
    if a is None:
        out = bytearray(48)
        out[-1] |= 0x40
        return bytes(out)
    x, y = a
    out = bytearray(x.to_bytes(48, "little"))
    if y > (Q - y) % Q:
        out[-1] |= 0x80
    return bytes(out)
