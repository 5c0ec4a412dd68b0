"""BinFHE cells: the port's BinFHEContext under the benchmark's own keys.

Set-up makes every input from the seed, on the device: the ternary LWE
secret s (n) and ring secret z (N); the GINX bootstrapping key, per
coordinate i and CMUX key k (s_i = 1, s_i = -1) and gadget row r an RLWE
sample (a, e + a z) in EVAL form with B_g^(r/2 + 1) added to a (even r)
or b (odd r) where the key's condition holds; the switching key, per
coordinate of z, digit value j and digit k an LWE sample of j B_ks^k z_i
under s mod q_KS; and a pool of LWE encryptions of random bits (a
uniform mod q, b = <a, s> + e + m q / 4). The context takes these keys in
place of its own BTKeyGen's: the reference works from the same ones.
`program_params` and `install_keys` are the one place that reaches under
the port's public API, and `tests/test_bench_keys.py` holds them to it.

Requests (`gate`): EvalBinGate of the request's gate over `batch` pairs,
the first operand the previous output where the mix chains them. Each
request's pool indices are put on the device at set-up, so that issuing
a request never waits for the host's copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import binfhe as ref
from reference import ntt as rntt

from .. import work

SIGMA = 3.19
PICK_BLOCK = 1 << 13       # requests whose pool indices go up at once
DECRYPTED = 1 << 14        # gates whose answers a run decrypts
TRUTH = {"AND": np.logical_and, "OR": np.logical_or,
         "NAND": lambda a, b: ~(a & b), "NOR": lambda a, b: ~(a | b)}


def program_params(cc) -> tuple:
    """The port's parameter set as the configuration states it: (n, N, q,
    Q, q_KS, B_KS, B_g)."""
    return (cc.n, cc.N, cc.q, cc.Q, cc.q_ks, cc.base_ks, cc.rgsw.base_g)


def install_keys(cc, z: torch.Tensor, bt_key: torch.Tensor,
                 ks_a: torch.Tensor, ks_b: torch.Tensor) -> None:
    """Give `cc` the ring secret z [N], the GINX key bt_key [n, 2, d_g, 2,
    N] and the switching key (ks_a [N, B_KS, d_KS, n], ks_b [N, B_KS,
    d_KS]) where BTKeyGen puts its own."""
    from openfhe_tpu_torch.binfhe import lwe

    cc.sk_n = lwe.LWEPrivateKey(s=z.int())
    cc.bt_key = bt_key
    cc.ks_key = lwe.LWESwitchingKey(a=ks_a, b=ks_b, mod_ks=cc.q_ks,
                                    base_ks=cc.base_ks)


class System:
    """One GINX configuration with one gate mix on one device."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from openfhe_tpu_torch import _build
        from openfhe_tpu_torch.binfhe import lwe
        from openfhe_tpu_torch.binfhe.constants import BINFHE_METHOD, BINGATE
        from openfhe_tpu_torch.binfhe.context import BinFHEContext

        self.build, self.lwe, self.gate_of = _build, lwe, BINGATE
        self.config, self.mix = config, mix
        self.device = torch.device(device)
        if mix["request"] != "gate":
            raise ValueError(f"no BinFHE request kind {mix['request']!r}")
        c = config
        self.n, self.ring, self.q, self.big_q = c["n"], c["ring_dim"], \
            c["q"], c["Q"]
        self.chain = bool(mix.get("chain"))
        self.batch = mix.get("batch", 1)
        self.units_per_request = self.batch
        self.keep_count = max(1, DECRYPTED // self.batch)
        g = ref.Ginx(self.n, self.ring, self.q, self.big_q, c["base_g"],
                     c["q_ks"], c["base_ks"], self.device)

        # -- the benchmark's inputs -------------------------------------
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed % (1 << 63))
        dev = self.device
        tern = lambda *shape: torch.randint(-1, 2, shape, generator=gen,
                                            device=dev)
        self.s, self.z = tern(self.n), tern(self.ring)
        big_q = self.big_q
        shape = (self.n, 2, g.d2, self.ring)
        a = torch.randint(0, big_q, shape, generator=gen, device=dev)
        e = torch.remainder(self._gauss(gen, shape), big_q)
        z_eval = g.fwd(torch.remainder(self.z, big_q))
        b = torch.remainder(g.fwd(e) + rntt.Exact.mul(a, z_eval, big_q),
                            big_q)
        cond = torch.stack([self.s == 1, self.s == -1], dim=1)   # [n, 2]
        gadget = torch.tensor([pow(c["base_g"], r // 2 + 1, big_q)
                               for r in range(g.d2)], device=dev)
        add = torch.where(cond[:, :, None], gadget, 0)[..., None]
        even = (torch.arange(g.d2, device=dev) % 2 == 0)[:, None]
        a = torch.remainder(a + torch.where(even, add, 0), big_q)
        b = torch.remainder(b + torch.where(even, 0, add), big_q)
        self.bt_key = torch.stack([a, b], dim=-2).int()     # [n, 2, d2, 2, N]
        q_ks, base_ks, d_ks = c["q_ks"], c["base_ks"], g.d_ks
        ks_shape = (self.ring, base_ks, d_ks)
        self.ks_a = torch.randint(0, q_ks, ks_shape + (self.n,), generator=gen,
                                  device=dev, dtype=torch.int32)
        jbk = torch.tensor([[j * pow(base_ks, k, q_ks) % q_ks
                             for k in range(d_ks)] for j in range(base_ks)],
                           device=dev)
        self.ks_b = torch.remainder(
            jbk[None] * self.z[:, None, None] + self._gauss(gen, ks_shape)
            + (self.ks_a.long() * self.s).sum(-1), q_ks).int()
        pool = mix["pool"]
        self.bits = torch.randint(0, 2, (pool,), generator=gen, device=dev)
        self.pool_a = torch.randint(0, self.q, (pool, self.n), generator=gen,
                                    device=dev, dtype=torch.int32)
        self.pool_b = torch.remainder(
            (self.pool_a.long() * self.s).sum(-1) + self._gauss(gen, (pool,))
            + self.bits * (self.q // 4), self.q).int()
        self.bits_host = self.bits.cpu().numpy().astype(bool)
        self.picks = None

        # -- the program -------------------------------------------------
        self.cc = BinFHEContext(seed=seed % (1 << 63), device=dev)
        self.cc.GenerateBinFHEContext(c["param_set"],
                                      BINFHE_METHOD[c["method"]])
        got = program_params(self.cc)
        want = (self.n, self.ring, self.q, self.big_q, q_ks, base_ks,
                c["base_g"])
        if got != want:
            raise RuntimeError(f"the program's {c['param_set']} is {got}, "
                               f"the configuration states {want}")
        install_keys(self.cc, self.z, self.bt_key, self.ks_a, self.ks_b)

    def _gauss(self, gen, shape):
        x = torch.randn(shape, generator=gen, device=self.device,
                        dtype=torch.float64) * SIGMA
        bound = math.ceil(6 * SIGMA)
        return torch.clamp(torch.round(x), -bound, bound).long()

    # -- the timed path -----------------------------------------------
    def stream(self, requests):
        """The requests, their pool indices put on the device a block of
        PICK_BLOCK requests at a time (a copy that waits for the card: the
        first block in set-up, a later one only where a window outruns
        it)."""
        self.first = self._prepare(requests)

        def gen():
            block = self.first
            while True:
                yield from block
                block = self._prepare(requests)
        return gen()

    def _prepare(self, requests):
        block = [next(requests) for _ in range(PICK_BLOCK)]
        picks = torch.from_numpy(np.stack([r["picks"] for r in block]))
        self.picks = (block[0]["index"], picks.to(self.device))
        return block

    def _operand(self, req, k):
        first, picks = self.picks
        idx = picks[req["index"] - first, k]
        return self.lwe.LWECiphertext(a=self.pool_a[idx], b=self.pool_b[idx],
                                      modulus=self.q, pt_modulus=4)

    def issue(self, req, prev=None):
        a = prev if (self.chain and prev is not None) else \
            self._operand(req, 0)
        return self.cc.EvalBinGate(self.gate_of[req["gate"]], a,
                                   self._operand(req, 1))

    def warm_requests(self):
        """The window's first request (every request has one shape)."""
        return [self.first[0]]

    def launches(self) -> int:
        return sum(self.build.LAUNCHES.values())

    def work(self, req):
        c = self.config
        return work.gate_batch(self.batch, self.n, self.ring,
                               math.log2(self.big_q), c["base_g"], c["q_ks"],
                               c["base_ks"])

    def free_program(self):
        self.cc = None

    # -- the check ------------------------------------------------------
    def expected(self, reqs) -> dict:
        """The plaintext answer [batch] of each request, by index; a chain
        follows the true answers from its first request."""
        out, last = {}, None
        for req in reqs:
            p = req["picks"]
            x = (last if (self.chain and last is not None)
                 else self.bits_host[p[0]])
            last = TRUTH[req["gate"]](x, self.bits_host[p[1]])
            out[req["index"]] = last
        return out

    def verify_all(self, kept, reqs) -> dict:
        """Decrypt the kept answers and count the gates whose bit is
        wrong."""
        truth = self.expected(reqs)
        a = torch.stack([o.a for _, o in kept])
        b = torch.stack([o.b for _, o in kept])
        got = ref.decrypt(a, b, self.s, self.q).cpu().numpy()
        want = np.stack([truth[r["index"]] for r, _ in kept]).astype(np.int64)
        wrong = got != want
        return {"wrong_bits": int(wrong.sum()),
                "wrong_requests": int(wrong.any(axis=1).sum()),
                "gates_decrypted": int(want.size)}

    def reference(self, records, ar=rntt.Exact) -> list:
        """The reference's answer to each sampled request, all sampled
        gates in one batch."""
        c = self.config
        g = ref.Ginx(self.n, self.ring, self.q, self.big_q, c["base_g"],
                     c["q_ks"], c["base_ks"], self.device, ar)
        a1, b1, a2, b2, gates = [], [], [], [], []
        for rec in records:
            p = torch.from_numpy(rec["req"]["picks"]).to(self.device)
            prev = rec["prev"]
            if self.chain and prev is not None:
                a1.append(prev.a.long())
                b1.append(prev.b.long())
            else:
                a1.append(self.pool_a[p[0]].long())
                b1.append(self.pool_b[p[0]].long())
            a2.append(self.pool_a[p[1]].long())
            b2.append(self.pool_b[p[1]].long())
            gates += [rec["req"]["gate"]] * self.batch
        cat = lambda xs: torch.cat(xs)
        oa, ob = g.gate(cat(a1), cat(b1), cat(a2), cat(b2), gates,
                        self.bt_key, self.ks_a, self.ks_b)
        return [(oa[i * self.batch:(i + 1) * self.batch],
                 ob[i * self.batch:(i + 1) * self.batch])
                for i in range(len(records))]

    @staticmethod
    def words(out) -> torch.Tensor:
        if hasattr(out, "a"):
            out = (out.a, out.b)
        a, b = out
        return torch.cat([a.long().reshape(-1), b.long().reshape(-1)])
