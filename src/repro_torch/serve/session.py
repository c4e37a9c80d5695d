"""Joint-inference serving session.

Counterpart of ``repro.serve.session``. ``InferenceSession`` holds the
trained per-client parameter stack on its device (restored via
``core.checkpoint.load_for_inference`` — params only), the per-client
features and neighbor tables, and answers node-classification queries
through the same split-model forward as exact full-graph inference.

Query path, per dispatch:

1. **Cache probe** at the top aggregation layer (L-1). If every queried
   node hits, the answer is assembled straight from cached aggregates and
   one tiny classifier matmul — no receptive field, no cross-client
   exchange, zero wire bytes.
2. Otherwise a **receptive-field plan** is built on the host (numpy,
   identical to the reference's): walking layers top-down, rows already
   cached at an aggregation layer are pruned, the remaining rows expand
   through the padded eval neighbor tables (``core.train._eval_tables``),
   and the plan is padded to bucketed static shapes.
3. One dispatch of ``core.glasu.serve_forward`` on the session's device
   (on CUDA every GCNII layer is one launch of the hand-written kernel for
   all clients), or with ``ServeConfig(engine="sharded")`` of the same
   forward on this rank's block of a ``torch.distributed`` client mesh
   (``mesh=``; ``close`` releases the mesh), runs the plan with cached
   rows injected after each aggregation; fresh aggregates are written
   back to the cache keyed on (node, layer) at the current
   ``params_version``.

On a streamed feature store (the power-law profiles) the session holds
only the neighbor tables; each plan gathers its level-0 rows from the store
(only the plan's rows leave disk), a plan that would reach the identity set
at level 0 and ``precompute()`` refuse. At a million nodes a 16-query
bucket's level 0 holds 67600 source rows, which ``ops.graph_agg`` sends
through the CSR segment-sum kernel.

Byte accounting prices exactly the FRESH rows at each aggregation layer,
at the wire size of the session codec (``comm.compression``; float32
without one), as the reference's ``_price`` does. A ``compression`` block
runs each aggregation of a cold answer through that codec; a warm answer
stays at zero bytes. ``ServeConfig(record_log=True)`` attaches to every
answer the per-query ``MessageLog`` that ``fed.simulation.log_query_traffic``
replays from the same fresh-row counts, whose total is the answer's
``upload_bytes + broadcast_bytes + index_bytes``.

Each dispatch opens a ``serve.dispatch`` span (``spans``), whose duration
is the answer's ``latency_s``; the probe, plan, staging copies, forward
enqueue and readbacks inside it open spans of their own
(``docs/TRACING.md``).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import spans
from ..comm.compression import make_compressor
from ..core import checkpoint, glasu
from ..core.train import _eval_neighbor_tables, _eval_tables
from ..device import resolve_device
from ..fed.simulation import MessageLog, log_query_traffic
from ..graph.feature_store import is_streamed
from ..graph.sampler import SampledBatch
from ..launch.mesh import make_client_mesh
from ..launch.sharding import local_inputs
from .cache import HotNodeCache
from .config import ServeConfig
from .metrics import ServeAnswer, ServeMetrics

_UNSET = object()


class QueryPlan(NamedTuple):
    batch: SampledBatch          # device tensors, bucket-static shapes
    inject: Dict[int, Any]       # agg layer -> (keep (n,), rows (M,n,h_agg))
    fresh: Dict[int, int]        # agg layer -> rows exchanged fresh
    fills: Dict[int, Any]        # agg layer -> (ids (n,), compute mask (n,))


class InferenceSession:
    """Answer node-classification queries on a trained GLASU model.

    ``device`` defaults to CUDA and raises where there is none; pass
    ``device="cpu"`` for the plain PyTorch versions. ``params`` is the
    client-stacked tree of tensors (``checkpoint.params_from_numpy`` turns
    a reference tree into one); it is moved to ``device``.
    """

    def __init__(self, params, config, data=None, *, serve=None,
                 compression=_UNSET, params_version: int = 0, device=None):
        self.device = resolve_device(device)
        if compression is not _UNSET:
            config = config.with_(compression=compression)
        if serve is None:
            serve = getattr(config, "serve", None) or ServeConfig()
        elif isinstance(serve, dict):
            serve = ServeConfig(**serve)
        self.config = config
        self.serve = serve
        if data is None:
            from ..graph.synth import make_vfl_dataset
            data = make_vfl_dataset(config.dataset,
                                    n_clients=config.n_clients,
                                    seed=config.seed)
            if config.method == "centralized":
                from ..core.train import make_centralized_dataset
                data = make_centralized_dataset(data)
        self.data = data
        self.mcfg = config.glasu_config(data)
        self._comp = make_compressor(self.mcfg.compression)
        self.params = checkpoint.tree_map(lambda t: t.to(self.device), params)
        self.params_version = int(params_version)

        m = self.mcfg
        self.M, self.L, self.N = m.n_clients, m.n_layers, data.n_nodes
        self.h_agg = m.hidden * (self.M if m.agg == "concat" else 1)
        self._d_pad = max(c.feat_dim for c in data.clients)
        self._streamed = any(is_streamed(c.features) for c in data.clients)
        if self._streamed:
            # streamed store: neighbor tables only, on the host; level-0
            # features are gathered per plan through the store's LRU (never
            # all N rows), and nothing sweeps the whole graph on the device
            nbr_idx, nbr_mask = _eval_neighbor_tables(
                data, config.eval_table_cap, config.seed)
            self._np_feats = self._feats_dev = None
            self._nbr_idx_dev = self._nbr_mask_dev = None
        else:
            feats, nbr_idx, nbr_mask = _eval_tables(
                data, config.eval_table_cap, config.seed)
            self._np_feats = feats                    # (M, N, d_pad) host
            self._feats_dev = self._stage(feats)
            self._nbr_idx_dev = self._stage(nbr_idx)
            self._nbr_mask_dev = self._stage(nbr_mask)
        self._nbr_idx = nbr_idx                       # (M, N, W) host
        self._nbr_mask = nbr_mask
        self.W = self._nbr_idx.shape[-1]
        self._identity = np.arange(self.N, dtype=np.int32)

        self.cache = HotNodeCache(serve.cache_entries, serve.max_staleness)
        self.metrics = ServeMetrics()
        self._lock = threading.Lock()
        self._sizes: Dict[int, list] = {}

        self._mesh = None
        if serve.engine == "sharded":
            self._mesh = make_client_mesh(self.M,
                                          max_devices=config.mesh_devices,
                                          device=self.device)
            self._fwd = self._sharded_forward
        else:
            self._fwd = lambda p, b, inj: glasu.serve_forward(
                p, b, self.mcfg, compressor=self._comp, cache_inject=inj)

    def _sharded_forward(self, params, batch, inject):
        """``serve_forward`` on this rank's block of clients, its outputs
        gathered back to the global (M, ...) stacks."""
        mesh = self._mesh
        params, batch = local_inputs(params, batch, mesh)
        h, aggs = glasu.serve_forward(params, batch, self.mcfg, self._comp,
                                      inject, mesh=mesh)
        return mesh.gather(h), {l: mesh.gather(a) for l, a in aggs.items()}

    def close(self) -> None:
        """Release the sharded engine's client mesh (and the one-rank
        process group it may have built); a no-op for the vmapped one."""
        if self._mesh is not None:
            self._mesh.close()

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        with spans.span("serve.stage") as rec:
            arr = np.ascontiguousarray(arr)
            rec.attrs["bytes"] = arr.nbytes
            return torch.from_numpy(arr).to(self.device)

    @staticmethod
    def _readback(t: torch.Tensor) -> np.ndarray:
        """``t`` on the host: where the host waits for the device."""
        with spans.span("serve.readback") as rec:
            out = t.cpu().numpy()
            rec.attrs["bytes"] = out.nbytes
            return out

    def _cls(self, rows, real):
        """Per-client classifier heads and their ensemble mean. Pad rows
        are zeroed BEFORE the head so warm/cold assembly of the same real
        rows is bitwise identical regardless of pad junk."""
        rows = rows * real[None, :, None]
        per = glasu._linear(self.params["cls"], rows)
        return per, per.mean(dim=0)

    # ------------------------------------------------------------ factory
    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, step: Optional[int] = None,
                        data=None, *, serve=None, compression=_UNSET,
                        device=None):
        """Build a session from a reference training checkpoint directory
        (params only). ``params_version`` starts at the restored step."""
        r = checkpoint.load_for_inference(ckpt_dir, step=step, data=data,
                                          device=device)
        return cls(r.params, r.config, r.data, serve=serve,
                   compression=compression, params_version=r.step,
                   device=device)

    # --------------------------------------------------------- query plan
    def _plan_sizes(self, bucket: int) -> list:
        """Static per-level set sizes for one bucket: level L holds the
        padded queries; each level below can add at most M*(W-1) table
        neighbors per computed row, capped at N (identity set)."""
        if bucket not in self._sizes:
            sizes = [0] * (self.L + 1)
            sizes[self.L] = bucket
            grow = 1 + self.M * (self.W - 1)
            for l in range(self.L - 1, -1, -1):
                sizes[l] = min(self.N, sizes[l + 1] * grow)
            self._sizes[bucket] = sizes
        return self._sizes[bucket]

    def _bucket(self, b: int) -> int:
        for bk in self.serve.resolved_buckets():
            if bk >= b:
                return bk
        raise ValueError(f"batch of {b} exceeds largest bucket "
                         f"{self.serve.resolved_buckets()[-1]}")

    def _build_plan(self, q_ids: np.ndarray, bucket: int,
                    top_hit: np.ndarray, top_rows: np.ndarray) -> QueryPlan:
        """Receptive-field plan for one padded query batch (host numpy).

        Top-down: decide per level which rows must be computed (needed,
        real, not cache-hit), expand only those rows' neighbors into the
        level below, and keep EVERY real row's self-chain so the backbone's
        h0/self_pos bookkeeping stays node-aligned (GCNII reads h0 at the
        self position of every layer). ``top_hit``/``top_rows`` are the
        already-probed cache state at layer L-1.
        """
        M, L, N = self.M, self.L, self.N
        agg_layers = self.mcfg.agg_layers
        sizes = self._plan_sizes(bucket)
        b = len(q_ids)

        sets = [None] * (L + 1)
        needs = [None] * (L + 1)
        computes = [None] * L
        inject: Dict[int, Any] = {}
        fresh: Dict[int, int] = {}
        fills: Dict[int, Any] = {}

        ids = np.full(bucket, -1, dtype=np.int32)
        ids[:b] = q_ids
        sets[L] = ids
        needs[L] = ids >= 0

        for l in range(L - 1, -1, -1):
            cur, need = sets[l + 1], needs[l + 1]
            real = cur >= 0
            if l in agg_layers:
                n_out = sizes[l + 1]
                if l == L - 1:
                    hit = np.zeros(n_out, dtype=np.float32)
                    hit[:len(top_hit)] = top_hit
                    rows = np.zeros((n_out, M, self.h_agg),
                                    dtype=np.float32)
                    rows[:len(top_rows)] = top_rows
                else:
                    hit, rows = self.cache.lookup(
                        l, np.where(need & real, cur, -1),
                        self.params_version, (M, self.h_agg))
                hitb = (hit > 0) & real & need
                compute = need & real & ~hitb
                inject[l] = (hitb.astype(np.float32),
                             np.ascontiguousarray(rows.transpose(1, 0, 2)))
                fresh[l] = int(compute.sum())
                fills[l] = (cur.copy(), compute.copy())
            else:
                compute = need & real
            computes[l] = compute

            n_in = sizes[l]
            cnodes = cur[compute]
            if len(cnodes):
                nb = self._nbr_idx[:, cnodes, :]
                nbr_ids = nb[self._nbr_mask[:, cnodes, :] > 0]
                need_ids = np.unique(np.concatenate([cnodes, nbr_ids]))
            else:
                need_ids = cnodes
            if n_in == N:
                sets[l] = self._identity
                nmask = np.zeros(N, dtype=bool)
                nmask[need_ids] = True
                needs[l] = nmask
            else:
                self_ids = np.unique(cur[real])
                src_ids = np.union1d(self_ids, need_ids)
                ids_l = np.full(n_in, -1, dtype=np.int32)
                ids_l[:len(src_ids)] = src_ids
                sets[l] = ids_l
                nmask = np.zeros(n_in, dtype=bool)
                nmask[:len(src_ids)] = np.isin(src_ids, need_ids)
                needs[l] = nmask

        gi_t, gm_t, rv_t, sp_t = [], [], [], []
        lut = np.full(N, -1, dtype=np.int32)
        for l in range(L):
            src, dst = sets[l], sets[l + 1]
            n_in, n_out = sizes[l], sizes[l + 1]
            safe_dst = np.maximum(dst, 0)
            ti = self._nbr_idx[:, safe_dst, :]           # (M, n_out, W)
            tm = self._nbr_mask[:, safe_dst, :]
            if n_in == N:
                pos, selfpos = ti, safe_dst
            else:
                srcr = src[src >= 0]
                lut[srcr] = np.arange(len(srcr), dtype=np.int32)
                pos, selfpos = lut[ti], lut[safe_dst]
                lut[srcr] = -1                           # reusable buffer
            gm = (tm * (pos >= 0)
                  * computes[l][None, :, None]).astype(np.float32)
            gi = np.maximum(pos, 0).astype(np.int32)
            # force column 0 = the row's own position: every row (cached,
            # chain-only, padding) gathers at least one valid entry, so
            # every h_plus is finite
            sp = np.maximum(selfpos, 0).astype(np.int32)
            gi[:, :, 0] = sp[None, :]
            gm[:, :, 0] = 1.0
            gi_t.append(self._stage(gi))
            gm_t.append(self._stage(gm))
            rv_t.append(self._stage(np.broadcast_to(
                (dst >= 0).astype(np.float32), (M, n_out))))
            sp_t.append(self._stage(np.broadcast_to(sp, (M, n_out))))

        src0 = sets[0]
        if sizes[0] == N:
            if self._streamed:
                raise RuntimeError(
                    "query plan reached the identity set at level 0, which "
                    "a streamed feature store cannot materialize; lower the "
                    "serve buckets / eval_table_cap for this graph scale")
            feats = self._feats_dev          # resident; no per-query copy
        else:
            feats = self._stage(self._gather_feats(src0))
        # labels are a dead input on the serve path
        labels = torch.zeros(bucket, dtype=torch.int32, device=self.device)
        batch = SampledBatch(
            feats=feats, gather_idx=tuple(gi_t), gather_mask=tuple(gm_t),
            row_valid=tuple(rv_t), labels=labels, self_pos=tuple(sp_t))
        inject_dev = {l: (self._stage(k), self._stage(r))
                      for l, (k, r) in inject.items()}
        return QueryPlan(batch=batch, inject=inject_dev, fresh=fresh,
                         fills=fills)

    def _gather_feats(self, src0: np.ndarray) -> np.ndarray:
        """(M, n, d_pad) level-0 feature block for one plan: resident-array
        slice on small graphs, per-client store row gather when streamed
        (only the plan's rows ever leave disk)."""
        with spans.span("serve.gather", rows=len(src0)):
            valid = (src0 >= 0).astype(np.float32)[None, :, None]
            if not self._streamed:
                return self._np_feats[:, np.maximum(src0, 0), :] * valid
            safe = np.maximum(src0, 0)
            f = np.zeros((self.M, len(src0), self._d_pad), np.float32)
            for m, c in enumerate(self.data.clients):
                rows = c.features[safe]
                f[m, :, :rows.shape[1]] = rows
            return f * valid

    # ----------------------------------------------------------- serving
    def _wire(self, n: int, d: int) -> int:
        if self._comp is None:
            return n * d * 4
        return self._comp.wire_bytes(n, d)

    def _price(self, fresh: Dict[int, int]) -> Tuple[int, int, int]:
        """(upload, broadcast, index) bytes for one query's fresh rows:
        each client uploads its (n_fresh, hidden) block, receives the
        (n_fresh, h_agg) aggregate back, both at the codec's wire size,
        plus the int32 fresh-row ids."""
        m = self.mcfg
        up = down = idx = 0
        for l in m.agg_layers:
            n = fresh.get(l, 0)
            if n == 0:
                continue
            up += self.M * self._wire(n, m.hidden)
            down += self.M * self._wire(n, self.h_agg)
            idx += self.M * n * 4
        return up, down, idx

    def answer(self, nodes) -> ServeAnswer:
        """Answer a node-classification query for ``nodes`` (any order,
        duplicates fine). Requests beyond ``max_batch`` are split into
        sequential dispatches and recombined."""
        nodes = np.asarray(nodes, dtype=np.int32).ravel()
        if nodes.size == 0:
            raise ValueError("empty query")
        if nodes.min() < 0 or nodes.max() >= self.N:
            raise ValueError(
                f"query ids must be in [0, {self.N}), got range "
                f"[{nodes.min()}, {nodes.max()}]")
        mb = self.serve.max_batch
        chunks = [nodes[i:i + mb] for i in range(0, len(nodes), mb)]
        answers = []
        with spans.span("serve.answer", ids=len(nodes)), self._lock, \
                torch.inference_mode():
            for c in chunks:
                ans = self._answer_locked(c)
                self.metrics.record(ans)
                answers.append(ans)
        if len(answers) == 1:
            return answers[0]
        return ServeAnswer(
            nodes=nodes,
            logits=np.concatenate([a.logits for a in answers]),
            per_client=np.concatenate([a.per_client for a in answers],
                                      axis=1),
            preds=np.concatenate([a.preds for a in answers]),
            fresh_rows={l: sum(a.fresh_rows.get(l, 0) for a in answers)
                        for l in self.mcfg.agg_layers},
            upload_bytes=sum(a.upload_bytes for a in answers),
            broadcast_bytes=sum(a.broadcast_bytes for a in answers),
            index_bytes=sum(a.index_bytes for a in answers),
            cache_hits=sum(a.cache_hits for a in answers),
            cache_misses=sum(a.cache_misses for a in answers),
            latency_s=sum(a.latency_s for a in answers),
            cold=any(a.cold for a in answers),
            params_version=self.params_version,
            log=answers[0].log)

    def _answer_locked(self, nodes: np.ndarray) -> ServeAnswer:
        """One dispatch of at most ``max_batch`` ids; its ``latency_s`` is
        the duration of its ``serve.dispatch`` span."""
        with spans.timed("serve.dispatch") as rec:
            ans = self._dispatch(nodes, rec)
        ans.latency_s = rec.duration_ns / 1e9
        return ans

    def _dispatch(self, nodes: np.ndarray, rec) -> ServeAnswer:
        """The dispatch's work; ``rec``, its open span, takes its attrs."""
        m = self.mcfg
        uniq, inv = np.unique(nodes, return_inverse=True)
        b = len(uniq)
        bucket = self._bucket(b)
        top = self.L - 1 if self.mcfg.agg_layers else None

        if top is not None:
            top_hit, top_rows = self.cache.lookup(
                top, uniq, self.params_version, (self.M, self.h_agg))
        else:
            top_hit = np.zeros(b, dtype=np.float32)
            top_rows = np.zeros((b, self.M, self.h_agg), dtype=np.float32)

        if top is not None and bool(top_hit.all()):
            # warm fast path: no plan, no layer stack, zero wire bytes
            rows = np.zeros((bucket, self.M, self.h_agg), dtype=np.float32)
            rows[:b] = top_rows
            fresh = {l: 0 for l in m.agg_layers}
            cold = False
        else:
            with spans.span("serve.plan"):
                plan = self._build_plan(uniq, bucket, top_hit, top_rows)
            with spans.span("serve.forward"):
                h, aggs = self._fwd(self.params, plan.batch, plan.inject)
            # host roundtrip on purpose: the warm path assembles the same
            # f32 rows from cache, so both paths feed the classifier
            # bitwise-identical arrays
            rows = np.ascontiguousarray(
                self._readback(h).transpose(1, 0, 2)).astype(
                    np.float32, copy=False)
            for l, (ids_l, comp) in plan.fills.items():
                if comp.any():
                    stack = self._readback(aggs[l])    # (M, n, h_agg)
                    self.cache.insert(
                        l, ids_l[comp], self.params_version,
                        np.ascontiguousarray(
                            stack[:, comp, :].transpose(1, 0, 2)))
            fresh = plan.fresh
            cold = True
        rec.attrs.update(ids=b, bucket=bucket, cold=cold)

        real = np.zeros(bucket, dtype=np.float32)
        real[:b] = 1.0
        rows, real = self._stage(rows.transpose(1, 0, 2)), self._stage(real)
        with spans.span("serve.forward"):
            per, ens = self._cls(rows, real)
        per = self._readback(per)[:, :b, :][:, inv, :]
        ens = self._readback(ens)[:b][inv]
        up, down, idx = self._price(fresh)
        # hit/miss on the answer are the top-layer probe's outcome — the
        # decision that picks warm vs cold
        n_hit = int((top_hit > 0).sum())
        n_miss = b - n_hit
        log = None
        if self.serve.record_log:
            log = MessageLog()
            log_query_traffic(log, fresh, m, compressor=self._comp)
        return ServeAnswer(
            nodes=np.array(nodes), logits=ens, per_client=per,
            preds=np.argmax(ens, axis=-1).astype(np.int32),
            fresh_rows=dict(fresh), upload_bytes=up, broadcast_bytes=down,
            index_bytes=idx, cache_hits=n_hit, cache_misses=n_miss,
            latency_s=0.0, cold=cold,
            params_version=self.params_version, log=log)

    # -------------------------------------------------------- management
    def update_params(self, params, version: Optional[int] = None):
        """Swap in new parameters (moved to the session's device) and bump
        ``params_version``; cache entries outside the staleness bound are
        evicted immediately."""
        with self._lock:
            self.params = checkpoint.tree_map(lambda t: t.to(self.device),
                                              params)
            self.params_version = (int(version) if version is not None
                                   else self.params_version + 1)
            self.cache.drop_older_than(self.params_version)

    def precompute(self, chunk: int = 4096) -> np.ndarray:
        """Warm the cache for EVERY node from one exact chunked
        ``full_forward`` sweep; returns the (M, N, C) full-graph logits.
        The collected aggregate stacks carry exactly the N real nodes, so
        chunk padding can never enter the cache."""
        if self._streamed:
            raise RuntimeError(
                "precompute() sweeps full_forward over all N nodes with "
                "resident features; a streamed-store session warms its "
                "cache through served queries instead")
        with self._lock, torch.inference_mode():
            logits, aggs = glasu.full_forward(
                self.params, self.mcfg, self._feats_dev,
                self._nbr_idx_dev, self._nbr_mask_dev, chunk=chunk,
                collect_agg=True)
            for l, stack in aggs.items():
                self.cache.insert(
                    l, self._identity, self.params_version,
                    np.ascontiguousarray(
                        stack.cpu().numpy().transpose(1, 0, 2)))
            return logits.cpu().numpy()
