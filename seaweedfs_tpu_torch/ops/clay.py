"""Clay codes — MSR regenerating codes with optimal repair bandwidth.

The port's own copy of the numpy oracle (the JAX package has the same
construction; the port imports nothing of it).  Beyond the reference's
fixed RS(10,4) (erasure_coding/ec_encoder.go): an MDS code whose
single-node repair reads a FRACTION of each helper instead of whole
shards.  Construction follows "Clay Codes: Moulding MDS Codes to Yield
Vector Codes"
(Vajha et al., FAST'18) — the code Ceph ships as `clay` — implemented
independently here over the repo's GF(2^8) tables (ops/gf256.py) and
klauspost-compatible layer MDS code (ops/rs_matrix.py).

Shape of the construction (q = m, t = ceil((k+m)/q), n0 = q*t):
- nodes sit on a q x t grid; each node stores alpha = q^t symbols,
  one per "layer" z in Z_q^t (sub-packetization alpha);
- every layer of UNCOUPLED symbols U is a codeword of a scalar
  (n0, n0-m) MDS code;
- stored symbols C couple in pairs across layers: for vertex v=(x,y)
  in layer z with z_y != x, the companion cell is (v*=(z_y,y),
  z* = z with y-th digit := x) and
      U[v,z]   = C[v,z]   + g * C[v*,z*]
      U[v*,z*] = C[v*,z*] + g * C[v,z]
  (symmetric pairing, det = 1 + g^2 != 0); diagonal cells (z_y == x)
  have U = C.  Data nodes store raw data (systematic).
- (k+m) < n0 is handled by shortening: n0-m-k virtual data nodes are
  identically zero and never stored or read.

Why it matters: repairing ONE lost node reads only beta = alpha/q
symbols from each of the n0-1 helpers (the "repair plane" z_{y0}=x0)
— for (k=10, m=4): 13 real helpers x 64 of 256 symbols = 832 symbol
units vs RS(10,4)'s k*alpha = 2560, a 3.1x repair-bandwidth cut at
the SAME storage overhead and MDS fault tolerance.

Decode (<= m arbitrary node losses) schedules layers by intersection
score iota(z) = #erased diagonal vertices, ascending: every non-erased
vertex's U is then computable (companion either stored or recovered
from an earlier layer), leaving <= m unknowns per layer — a plain MDS
erasure solve.  Encode = decode with the parity nodes as the erasures.

The per-layer solves are GF(2^8) matmuls over [n0, B] blocks; on the
GPU the structured encode and the single-loss repair run them inside the
fused kernels of csrc/clay_fused.cu (ops/clay_structured.py), and the
flat decode matrices go through codec.gf_apply.  This numpy
implementation is the correctness oracle and the repair planner.
"""

from __future__ import annotations

import numpy as np

from . import gf256, rs_matrix

GAMMA = 2          # coupling coefficient; 1 + g^2 = 5 != 0 in GF(2^8)


class ClayCode:
    def __init__(self, k: int = 10, m: int = 4):
        if m < 2:
            raise ValueError("clay needs m >= 2")
        self.k = k
        self.m = m
        self.q = m
        self.t = -(-(k + m) // self.q)        # ceil
        self.n0 = self.q * self.t
        self.alpha = self.q ** self.t
        self.beta = self.alpha // self.q
        self.virtual = self.n0 - m - k        # shortened zero nodes
        # internal node ids: 0..k-1 data, k..k+virtual-1 virtual zeros,
        # last m are parity; grid position of internal node i: (x, y) =
        # (i % q, i // q)
        self.data_ids = list(range(k))
        self.virtual_ids = list(range(k, k + self.virtual))
        self.parity_ids = list(range(self.n0 - m, self.n0))
        # layer MDS code: klauspost-construction (n0, n0-m) generator
        self.k0 = self.n0 - m
        self.gen = rs_matrix.generator_matrix(self.k0, m)   # [n0, k0]
        self._det_inv = gf256.inv(np.uint8(1 ^ gf256.mul(GAMMA, GAMMA)))
        # per-instance (not lru_cache-on-method, which would pin the
        # instance in a process-global cache for the process lifetime)
        self._recover_cache: dict[tuple, np.ndarray] = {}

    # -- grid / layer arithmetic -------------------------------------------
    def _xy(self, node: int) -> tuple[int, int]:
        return node % self.q, node // self.q

    def _node(self, x: int, y: int) -> int:
        return y * self.q + x

    def _digit(self, z: int, y: int) -> int:
        return (z // (self.q ** y)) % self.q

    def _with_digit(self, z: int, y: int, x: int) -> int:
        p = self.q ** y
        return z - self._digit(z, y) * p + x * p

    def _iota(self, z: int, erased: set[int]) -> int:
        return sum(1 for y in range(self.t)
                   if self._node(self._digit(z, y), y) in erased)

    # -- per-layer MDS solve ------------------------------------------------
    def _recover_matrix(self, known: tuple[int, ...],
                        unknown: tuple[int, ...]) -> np.ndarray:
        """[len(unknown), k0] matrix R with U_unknown = R @ U_known[:k0]
        (any k0 rows of an MDS generator are invertible)."""
        cached = self._recover_cache.get((known, unknown))
        if cached is not None:
            return cached
        sub = self.gen[list(known[:self.k0])]          # [k0, k0]
        inv = gf256.mat_inv(sub)
        out = gf256.matmul(self.gen[list(unknown)], inv)
        if len(self._recover_cache) < 64:
            self._recover_cache[(known, unknown)] = out
        return out

    def _solve_layer(self, U: dict[int, np.ndarray],
                     unknown: list[int], B: int) -> None:
        known = tuple(sorted(set(range(self.n0)) - set(unknown)))
        R = self._recover_matrix(known, tuple(sorted(unknown)))
        stacked = np.stack([U[i] for i in known[:self.k0]])   # [k0, B]
        out = gf256.matmul(R, stacked)
        for row, i in enumerate(sorted(unknown)):
            U[i] = out[row]

    # -- coupling -----------------------------------------------------------
    def _pair(self, node: int, z: int) -> "tuple[int, int] | None":
        x, y = self._xy(node)
        w = self._digit(z, y)
        if w == x:
            return None                        # diagonal: U = C
        return self._node(w, y), self._with_digit(z, y, x)

    def _uncouple(self, c_here: np.ndarray,
                  c_pair: np.ndarray) -> np.ndarray:
        return c_here ^ gf256.mul(np.uint8(GAMMA), c_pair)

    def _c_from_u_and_pair_c(self, u_here: np.ndarray,
                             c_pair: np.ndarray) -> np.ndarray:
        return u_here ^ gf256.mul(np.uint8(GAMMA), c_pair)

    def _solve_pair(self, u_here: np.ndarray, u_pair: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Both C's of a coupled pair from both U's:
        C1 = (U1 + g*U2) / (1 + g^2), symmetric for C2."""
        g = np.uint8(GAMMA)
        c1 = gf256.mul(self._det_inv, u_here ^ gf256.mul(g, u_pair))
        c2 = gf256.mul(self._det_inv, u_pair ^ gf256.mul(g, u_here))
        return c1, c2

    # -- core decode (<= m erased internal nodes) ---------------------------
    def _decode_internal(self, C: dict[tuple[int, int], np.ndarray],
                         erased: list[int], B: int) -> None:
        """Fill C[(node, z)] for every erased node cell, in place.
        C must hold every (node, z) cell of every non-erased node."""
        E = set(erased)
        layers = sorted(range(self.alpha),
                        key=lambda z: self._iota(z, E))
        U: dict[int, dict[int, np.ndarray]] = {}     # z -> node -> U
        for z in layers:
            u: dict[int, np.ndarray] = {}
            for node in range(self.n0):
                if node in E:
                    continue
                pair = self._pair(node, z)
                if pair is None:
                    u[node] = C[(node, z)]
                    continue
                pnode, pz = pair
                if pnode not in E:
                    u[node] = self._uncouple(C[(node, z)],
                                             C[(pnode, pz)])
                else:
                    # companion erased: its layer pz has iota(pz) =
                    # iota(z) - 1, already decoded -> C recovered there,
                    # or recover it now from that layer's U
                    c_pair = C.get((pnode, pz))
                    if c_pair is None:
                        c_pair = self._c_from_u_and_pair_c(
                            U[pz][pnode], C[(node, z)])
                        C[(pnode, pz)] = c_pair
                    u[node] = self._uncouple(C[(node, z)], c_pair)
            self._solve_layer(u, [e for e in E], B)
            U[z] = u
            # recover this layer's erased C cells where possible
            for node in E:
                if (node, z) in C:
                    continue
                pair = self._pair(node, z)
                if pair is None:
                    C[(node, z)] = u[node]
                    continue
                pnode, pz = pair
                if pnode not in E:
                    C[(node, z)] = self._c_from_u_and_pair_c(
                        u[node], C[(pnode, pz)])
                elif pz in U:
                    c1, c2 = self._solve_pair(u[node], U[pz][pnode])
                    C[(node, z)] = c1
                    C[(pnode, pz)] = c2
        # every erased cell must be recovered — a hole is a logic bug,
        # never silently zero-filled
        for node in E:
            for z in range(self.alpha):
                if (node, z) not in C:
                    raise RuntimeError(
                        f"clay decode left cell ({node},{z}) "
                        f"unrecovered")

    # -- public API ---------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, alpha, B] -> parity [m, alpha, B] (systematic: the
        k data nodes store `data` as-is)."""
        k, alpha, B = data.shape
        assert (k, alpha) == (self.k, self.alpha), (k, alpha)
        C = self._cells_from_known(data, {})
        self._decode_internal(C, self.parity_ids, B)
        return np.stack([
            np.stack([C[(p, z)] for z in range(self.alpha)])
            for p in self.parity_ids])

    def _cells_from_known(self, data: "np.ndarray | None",
                          parity: dict[int, np.ndarray],
                          skip: "set[int] | None" = None) -> dict:
        B = data.shape[-1] if data is not None else \
            next(iter(parity.values())).shape[-1]
        zero = np.zeros(B, dtype=np.uint8)
        C: dict[tuple[int, int], np.ndarray] = {}
        for v in self.virtual_ids:
            for z in range(self.alpha):
                C[(v, z)] = zero
        if data is not None:
            for i in self.data_ids:
                if skip and i in skip:
                    continue
                for z in range(self.alpha):
                    C[(i, z)] = np.ascontiguousarray(data[i, z])
        for ext, arr in parity.items():
            for z in range(self.alpha):
                C[(ext, z)] = np.ascontiguousarray(arr[z])
        return C

    def decode(self, shards: dict[int, np.ndarray],
               lost: list[int]) -> dict[int, np.ndarray]:
        """shards: external node id -> [alpha, B] for every surviving
        node; lost: external ids (data 0..k-1, parity k..k+m-1),
        len <= m.  -> recovered {id: [alpha, B]}."""
        if len(lost) > self.m:
            raise ValueError(f"at most {self.m} losses, got {len(lost)}")
        internal_lost = [self._internal(e) for e in lost]
        B = next(iter(shards.values())).shape[-1]
        C: dict[tuple[int, int], np.ndarray] = {}
        zero = np.zeros(B, dtype=np.uint8)
        for v in self.virtual_ids:
            for z in range(self.alpha):
                C[(v, z)] = zero
        for ext, arr in shards.items():
            node = self._internal(ext)
            for z in range(self.alpha):
                C[(node, z)] = np.ascontiguousarray(arr[z])
        self._decode_internal(C, internal_lost, B)
        return {ext: np.stack([C[(self._internal(ext), z)]
                               for z in range(self.alpha)])
                for ext in lost}

    def _internal(self, ext: int) -> int:
        if ext < self.k:
            return ext
        return self.n0 - self.m + (ext - self.k)

    def _external(self, internal: int) -> "int | None":
        if internal < self.k:
            return internal
        if internal >= self.n0 - self.m:
            return self.k + (internal - (self.n0 - self.m))
        return None          # virtual

    # -- optimal-bandwidth single-node repair ------------------------------
    def repair_plan(self, lost_ext: int) -> dict[int, list[int]]:
        """{helper external id: [layer indices to read]} — beta =
        alpha/q layers per helper, the repair plane z_{y0} = x0."""
        x0, y0 = self._xy(self._internal(lost_ext))
        plane = [z for z in range(self.alpha)
                 if self._digit(z, y0) == x0]
        plan: dict[int, list[int]] = {}
        for node in range(self.n0):
            ext = self._external(node)
            if ext is None or ext == lost_ext:
                continue
            plan[ext] = list(plane)
        return plan

    def repair(self, lost_ext: int,
               helper_symbols: dict[int, dict[int, np.ndarray]]
               ) -> np.ndarray:
        """helper_symbols: external id -> {layer z: [B]} covering the
        repair plan.  -> the lost node's full [alpha, B]."""
        lost = self._internal(lost_ext)
        x0, y0 = self._xy(lost)
        some = next(iter(helper_symbols.values()))
        B = next(iter(some.values())).shape[-1]
        zero = np.zeros(B, dtype=np.uint8)
        plane = [z for z in range(self.alpha)
                 if self._digit(z, y0) == x0]
        # C over plane cells: helpers' reads + virtual zeros
        C: dict[tuple[int, int], np.ndarray] = {}
        for z in plane:
            for v in self.virtual_ids:
                C[(v, z)] = zero
        for ext, sym in helper_symbols.items():
            node = self._internal(ext)
            for z, val in sym.items():
                C[(node, z)] = np.ascontiguousarray(val)
        out = np.zeros((self.alpha, B), dtype=np.uint8)
        U_plane: dict[int, dict[int, np.ndarray]] = {}
        for z in plane:
            u: dict[int, np.ndarray] = {}
            unknown = [lost]
            for node in range(self.n0):
                if node == lost:
                    continue
                x, y = self._xy(node)
                if y == y0:
                    # companion cell lives on the lost node, out of
                    # plane — U unknown; there are exactly q-1 of these
                    unknown.append(node)
                    continue
                pair = self._pair(node, z)
                if pair is None:
                    u[node] = C[(node, z)]
                else:
                    pnode, pz = pair      # pz stays in the plane
                    u[node] = self._uncouple(C[(node, z)],
                                             C[(pnode, pz)])
            self._solve_layer(u, unknown, B)
            U_plane[z] = u
            out[z] = u[lost]              # diagonal: C = U
        # out-of-plane cells of the lost node via coupling with the
        # y0-column helpers' plane cells
        for z in plane:
            for x in range(self.q):
                if x == x0:
                    continue
                helper = self._node(x, y0)
                zprime = self._with_digit(z, y0, x)   # out of plane
                # U[helper, z] = C[helper, z] + g * C[lost, zprime]
                # -> C[lost, zprime] = (U ^ C) / g
                out[zprime] = gf256.mul(
                    gf256.inv(np.uint8(GAMMA)),
                    U_plane[z][helper] ^ C[(helper, z)])
        return out

    # -- repair-bandwidth accounting (the planner's selling point) ---------
    def repair_read_symbols(self) -> int:
        """Symbols read to repair one node (real helpers only)."""
        real_helpers = self.k + self.m - 1
        return real_helpers * self.beta

    def rs_repair_read_symbols(self) -> int:
        """What RS(k, m) at the same sub-packetization reads: k whole
        shards."""
        return self.k * self.alpha
