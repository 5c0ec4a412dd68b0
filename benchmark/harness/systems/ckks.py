"""CKKS cells: the port's CryptoContext under the benchmark's own inputs.

Set-up makes every input from the seed, on the device: the ternary secret
s, for each switching key the uniform a_j and the small e_j of each digit,
and a pool of encryptions c = (-c1 s + m + e, c1) with uniform c1 at each
level of the mix (m with coefficients of about 2^20, e the rounded
Gaussian of sigma 3.19); for a linear transform one plaintext diagonal a
rotation and level, a polynomial with coefficients of about 2^20. They are
put into EVAL form with the reference's own transform, so the program and
the reference start from the same words. The program makes its switching
keys from these draws and its tables itself; the reference works out both
again. `install_keys` is the one place that reaches under the port's
public API, and `tests/test_bench_keys.py` holds it to that API.

Requests:

* `mult_rescale`: Rescale(EvalMult(a, b)), a and b from the level's pool;
* `hoisted_linear`: EvalFastRotationPrecompute(c), then the sum of
  EvalMult(EvalFastRotation(c, k), diagonal k) over k = 1 .. rotations and
  EvalMult(c, diagonal 0), then Rescale: a baby-step of a linear
  transform.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch

from reference import ckks as ref
from reference import ntt as rntt

from .. import traffic, work

SIGMA = 3.19
MESSAGE_SIGMA = float(1 << 20)


def _params(fhe, spec: dict):
    """CCParams from the configuration's `params`: numbers as they are,
    enum fields by member name."""
    defaults = fhe.CCParams()
    kw = {}
    for key, value in spec.items():
        default = getattr(defaults, key)
        kw[key] = (type(default)[value] if isinstance(default, enum.Enum)
                   else value)
    return dataclasses.replace(defaults, **kw)


def install_keys(cc, s_new: torch.Tensor, keys: dict,
                 tag: str = "bench") -> None:
    """Give `cc` the switching keys to s_new [kQ + kP, N] (EVAL words):
    for each g, (s_old, draws), the key s_old -> s_new that the port's
    KeySwitchGen makes from these draws (`hybrid.keyswitch_gen_core`, the
    draws a uniform a [kQ + kP, N] and a small e [N] a digit), put where
    EvalMultKeyGen (g = 1) or EvalAutomorphismKeyGen (g the automorphism)
    puts it under `tag`."""
    from openfhe_tpu_torch.pke.keys import PrivateKey
    from openfhe_tpu_torch.pke.keyswitch import hybrid

    sk = PrivateKey(s_qp=s_new, key_tag=tag)
    for g, (s_old, draws) in keys.items():
        ek = hybrid.keyswitch_gen_core(
            draws, PrivateKey(s_qp=s_old, key_tag=tag), sk, cc.basis_qp,
            len(cc.moduli_q), cc.params.num_large_digits, cc.p_modq,
            cc.p_modq_sh)
        if g == 1:
            cc.InsertEvalMultKey(ek, tag)
        else:
            cc.InsertEvalAutomorphismKey({g: ek}, tag)


class System:
    """One CKKS configuration with one traffic mix on one device."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        import openfhe_tpu_torch as fhe
        from openfhe_tpu_torch import _build
        from openfhe_tpu_torch.pke.ciphertext import Ciphertext, Plaintext

        self.build, self.mix = _build, mix
        self.device = torch.device(device)
        p = config["params"]
        self.n = p["ring_dim"]
        self.digits = p["num_large_digits"]
        self.mq, self.mp = tuple(config["moduli_q"]), tuple(config["moduli_p"])
        self.kq, self.kp = len(self.mq), len(self.mp)
        self.alpha = -(-self.kq // self.digits)
        self.delta = float(2 ** p["scaling_mod_size"])
        self.rotations = mix.get("rotations", 0)
        self.kind = mix["request"]
        if self.kind not in ("mult_rescale", "hoisted_linear"):
            raise ValueError(f"no CKKS request kind {self.kind!r}")
        self.units_per_request = 1

        # -- the benchmark's inputs -----------------------------------
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed % (1 << 63))
        self.chain = ref.Chain(self.mq, self.mp, self.n, self.digits,
                               self.device)
        ch = self.chain
        self.s_small = torch.randint(-1, 2, (self.n,), generator=gen,
                                     device=self.device)
        self.s = ch.lift(self.s_small)
        # the relinearization key (marked 1) or a key per rotation k, whose
        # automorphism is 5^k mod 2N
        self.rot_g = {k: pow(5, k, 2 * self.n)
                      for k in range(1, self.rotations + 1)}
        keys = [1] if self.kind == "mult_rescale" else self.rot_g.values()
        self.draws = {g: self._key_draws(gen) for g in keys}
        self.pool = {}
        for level in mix["levels"]:
            size = self.kq - level
            self.pool[level] = [self._encrypt(gen, size)
                                for _ in range(mix["pool"])]
        self.diag = {}
        if self.kind == "hoisted_linear":
            for level in mix["levels"]:
                idx = range(self.kq - level)
                q = ch.towers.q[:len(idx)]
                self.diag[level] = [
                    ch.fwd(torch.remainder(self._small(gen, MESSAGE_SIGMA),
                                           q), idx)
                    for _ in range(self.rotations + 1)]

        # -- the program -------------------------------------------------
        self.cc = fhe.GenCryptoContext(_params(fhe, p), seed=seed % (1 << 63),
                                       device=self.device)
        got = (tuple(self.cc.moduli_q), tuple(self.cc.moduli_p))
        if got != (self.mq, self.mp):
            raise RuntimeError("the program chose other moduli than the "
                               f"configuration states: {got}")
        install_keys(self.cc, self.s.int(), {
            g: ((self._mul(self.s, self.s) if g == 1
                 else ch.automorph(self.s, g)).int(),
                [d.int() for d in draws])
            for g, draws in self.draws.items()})
        mk_ct = lambda c, level: Ciphertext(
            elements=tuple(x.int() for x in c), level=level, noise_deg=1,
            scale=self.delta, slots=self.n // 2, key_tag="bench")
        self.ct = {lv: [mk_ct(c, lv) for c in cs]
                   for lv, cs in self.pool.items()}
        self.pt = {lv: [Plaintext(poly=d.int(), level=lv, noise_deg=1,
                                  scale=self.delta, slots=self.n // 2)
                        for d in ds] for lv, ds in self.diag.items()}

    # -- inputs --------------------------------------------------------
    def _mul(self, a, b):
        return rntt.Exact.mul(a, b, self.chain.towers.q)

    def _small(self, gen, sigma):
        x = torch.randn((self.n,), generator=gen, device=self.device,
                        dtype=torch.float64) * sigma
        bound = math.ceil(6 * sigma)
        return torch.clamp(torch.round(x), -bound, bound).long()

    def _uniform(self, gen, rows):
        raw = torch.randint(0, 1 << 62, (rows, self.n), generator=gen,
                            device=self.device, dtype=torch.int64)
        return torch.remainder(raw, self.chain.towers.q[:rows])

    def _key_draws(self, gen):
        out = []
        for _ in range(self.digits):
            out.append(self._uniform(gen, self.kq + self.kp))
            out.append(self._small(gen, SIGMA))
        return out

    def _encrypt(self, gen, size):
        ch = self.chain
        idx = range(size)
        q = ch.towers.q[:size]
        c1 = self._uniform(gen, size)
        me = self._small(gen, MESSAGE_SIGMA) + self._small(gen, SIGMA)
        me = ch.fwd(torch.remainder(me[None, :], q), idx)
        c0 = torch.remainder(me - rntt.Exact.mul(c1, self.s[:size], q), q)
        return c0, c1

    # -- the timed path -----------------------------------------------
    def issue(self, req, prev=None):
        cc, level = self.cc, req["level"]
        pool = self.ct[level]
        if self.kind == "mult_rescale":
            a, b = (pool[int(i)] for i in req["picks"][:2, 0])
            return cc.Rescale(cc.EvalMult(a, b))
        c = pool[int(req["picks"][0, 0])]
        pts = self.pt[level]
        digits = cc.EvalFastRotationPrecompute(c)
        acc = cc.EvalMult(c, pts[0])
        for k in range(1, self.rotations + 1):
            rot = cc.EvalFastRotation(c, k, 0, digits)
            acc = cc.EvalAdd(acc, cc.EvalMult(rot, pts[k]))
        return cc.Rescale(acc)

    def stream(self, requests):
        return requests

    def warm_requests(self):
        """One request of each level the mix takes."""
        seen = {}
        for req in traffic.requests(self.mix, 0):
            seen.setdefault(req["level"], req)
            if len(seen) == len(self.mix["levels"]):
                break
        return list(seen.values())

    def launches(self) -> int:
        return sum(self.build.LAUNCHES.values())

    def work(self, req):
        """(bytes, operations) of a request, from work.py's counts."""
        n, kp, a, d = self.n, self.kp, self.alpha, self.digits
        size = self.kq - req["level"]
        if self.kind == "mult_rescale":
            parts = [work.eval_mult(n, size, kp, a, d), work.rescale(n, size)]
        else:
            r = self.rotations
            parts = ([work.fast_rotation_precompute(n, size, kp, a, d)]
                     + [work.fast_rotation(n, size, kp, a, d)] * r
                     + [work.mult_plain(n, size)] * (r + 1)
                     + [work.add(n, size)] * r + [work.rescale(n, size)])
        return tuple(map(sum, zip(*parts)))

    def free_program(self):
        self.cc = self.ct = self.pt = None

    # -- the check ------------------------------------------------------
    def reference(self, records, ar=rntt.Exact) -> list:
        """The reference's answer to each sampled request, from the
        benchmark's inputs alone."""
        ch = ref.Chain(self.mq, self.mp, self.n, self.digits, self.device,
                       ar)
        keys = {}
        for g, draws in self.draws.items():
            s_old = (ar.mul(self.s, self.s, ch.towers.q) if g == 1
                     else ch.automorph(self.s, g))
            keys[g] = ch.keygen(s_old, self.s, draws)
        outs = []
        for rec in records:
            req = rec["req"]
            pool = self.pool[req["level"]]
            if self.kind == "mult_rescale":
                a, b = (pool[int(i)] for i in req["picks"][:2, 0])
                outs.append(ch.rescale(ch.eval_mult(a, b, *keys[1])))
                continue
            c = pool[int(req["picks"][0, 0])]
            diag = self.diag[req["level"]]
            digits = ch.mod_up(c[1])
            acc = ch.mult_plain(c, diag[0])
            for k in range(1, self.rotations + 1):
                g = self.rot_g[k]
                rot = ch.fast_rotation(c, digits, g, *keys[g])
                acc = ch.add(acc, ch.mult_plain(rot, diag[k]))
            outs.append(ch.rescale(acc))
        return outs

    @staticmethod
    def words(out) -> torch.Tensor:
        """The words a request's answer holds, as one int64 tensor."""
        if hasattr(out, "elements"):
            out = out.elements
        return torch.stack([x.long() for x in out])
