"""Unified experiment configuration — one validated surface for a scenario.

Counterpart of ``repro.api.config``: the same fields, defaults, validation
and derivations, so ``from_dict`` reads an ``experiment.json`` the JAX
package wrote and ``to_dict`` writes the same dict back.

  * ``agg_layers`` is derived from ``method``/``k`` (the paper's uniform
    placement) unless given explicitly, and validated to include the
    prediction layer (§3.1).
  * ``d_in`` / ``n_classes`` are read off the dataset at bind time
    (``glasu_config``).

Every backend of the reference runs: ``"vmapped"``, ``"simulation"`` and
``"sharded"``, with the reference's cross-field checks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from ..comm.compression import CompressionConfig
from ..core.glasu import GlasuConfig
from ..core.train import TrainConfig, legacy_optimizer_name
from ..fed.faults import FaultConfig
from ..graph.sampler import SamplerConfig
from ..optim import optimizers as opt_lib
from ..serve.config import ServeConfig

METHODS = ("glasu", "centralized", "standalone", "simulated-centralized",
           "fedbcd")
BACKENDS = ("vmapped", "simulation", "sharded")
OPTIMIZER_NAMES = opt_lib.OPTIMIZER_NAMES


def agg_layers_for_k(n_layers: int, k: int) -> Tuple[int, ...]:
    """Paper's 'uniform' placement: K=1 -> last; K=2 -> middle+last; K=L -> all."""
    if k >= n_layers:
        return tuple(range(n_layers))
    step = n_layers // k
    return tuple(sorted({n_layers - 1 - i * step for i in range(k)}))


@dataclass(frozen=True)
class ExperimentConfig:
    # ------------------------------------------------------------- scenario
    name: str = "glasu-experiment"
    dataset: str = "cora"
    method: str = "glasu"
    backend: str = "vmapped"
    mesh_devices: Optional[int] = None    # sharded: cap on client-mesh devices
    # --------------------------------------------------------------- model
    n_clients: int = 3                    # data parties M (model runs M=1 if centralized)
    n_layers: int = 4
    hidden: int = 64
    backbone: str = "gcnii"
    agg: str = "mean"                     # 'mean' | 'concat'
    agg_layers: Optional[Tuple[int, ...]] = None  # None -> derived from method/k
    k: Optional[int] = None               # |I|; used only when agg_layers is None
    n_local_steps: int = 1                # Q (stale updates)
    gcnii_alpha: float = 0.1
    gcnii_beta: float = 0.5
    gat_heads: int = 2
    dp_sigma: float = 0.0
    secure_agg: bool = False
    labels_at_client: Optional[int] = None
    use_pallas: bool = False
    # ----------------------------------------------------- dict-coerced blocks
    compression: Optional[CompressionConfig] = None
    serve: Optional[ServeConfig] = None
    faults: Optional[FaultConfig] = None
    # -------------------------------------------------------------- sampler
    batch_size: int = 16
    fanout: int = 3
    size_cap: int = 512
    table_cap: int = 64
    # ------------------------------------------------------------- training
    rounds: int = 200
    rounds_per_step: int = 1              # K rounds per scanned device step
    prefetch_buffers: int = 2             # sampler prefetch generations
    lr: float = 0.01
    optimizer: str = "adam"
    eval_every: int = 25
    eval_table_cap: int = 32
    seed: int = 0
    eval_mode: Optional[str] = None       # None -> 'per_client' iff standalone
    target_acc: Optional[float] = None    # early stop (paper Table 4)
    # -------------------------------------------------------- checkpointing
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0                   # rounds between saves (0 = final only)

    # ------------------------------------------------------------ validation
    def __post_init__(self):
        def err(msg):
            raise ValueError(f"ExperimentConfig {self.name!r}: {msg}")

        def coerce(field, cls):
            value = getattr(self, field)
            if isinstance(value, dict):
                try:
                    object.__setattr__(self, field, cls(**value))
                except (TypeError, ValueError) as e:
                    err(f"invalid {field} block: {e}")
            elif not (value is None or isinstance(value, cls)):
                err(f"{field} must be a {cls.__name__} or dict, got "
                    f"{type(value).__name__}")

        if self.method not in METHODS:
            err(f"unknown method {self.method!r}; expected one of {METHODS}")
        if self.backend not in BACKENDS:
            err(f"unknown backend {self.backend!r}; expected one of {BACKENDS}")
        if self.optimizer not in OPTIMIZER_NAMES:
            err(f"unknown optimizer {self.optimizer!r}; expected one of "
                f"{OPTIMIZER_NAMES}")
        if self.n_clients < 1 or self.n_layers < 1:
            err("n_clients and n_layers must be positive")
        if self.n_local_steps < 1:
            err("n_local_steps (Q) must be >= 1")
        if self.rounds < 0:
            err("rounds must be >= 0")
        if self.eval_every < 0:
            err("eval_every must be >= 0 (0 = no exact eval; the only "
                "option for streamed-store datasets, whose features never "
                "materialize)")
        if self.eval_every == 0 and self.target_acc is not None:
            err("target_acc early stopping needs periodic exact eval; set "
                "eval_every > 0")
        if self.rounds_per_step < 1:
            err("rounds_per_step must be >= 1")
        if self.prefetch_buffers < 1:
            err("prefetch_buffers must be >= 1")
        if self.agg not in ("mean", "concat"):
            err(f"unknown aggregation {self.agg!r}")
        if self.agg == "concat" and self.backbone != "gcn":
            err("concat aggregation is implemented for the gcn backbone only")
        if self.eval_mode not in (None, "ensemble", "per_client"):
            err(f"unknown eval_mode {self.eval_mode!r}")
        coerce("compression", CompressionConfig)
        coerce("serve", ServeConfig)
        coerce("faults", FaultConfig)
        if self.compression is not None and self.compression.active \
                and self.secure_agg:
            err("secure_agg masks cancel only exactly; compressed uploads "
                "break the pairwise cancellation — disable one of "
                "compression / secure_agg")
        if self.faults is not None:
            if self.secure_agg or self.dp_sigma > 0.0:
                err("fault tolerance is incompatible with the §3.6 privacy "
                    "hooks: pairwise masks and per-round DP noise assume "
                    "every client uploads every round")
            if self.labels_at_client is not None:
                err("fault tolerance does not implement labels_at_client "
                    "(the Alg 6 owner gradient assumes a synchronous "
                    "exchange)")
            if self.method == "standalone":
                err("faults model the aggregation exchange; standalone has "
                    "no communication to fault")
            if self.model_clients < 2:
                err("fault tolerance needs >= 2 model clients (a single "
                    "client's absence leaves nothing to aggregate)")

        # method-specific derivations / constraints
        if self.method == "simulated-centralized":
            if self.n_local_steps != 1:
                err("simulated-centralized requires Q == 1 (paper §3.5)")
            want = tuple(range(self.n_layers))
            if self.agg_layers is not None and tuple(self.agg_layers) != want:
                err("simulated-centralized aggregates at every layer; "
                    f"agg_layers must be {want} (or None to derive)")
            object.__setattr__(self, "agg_layers", want)
        elif self.method == "standalone":
            if self.agg_layers:
                err("standalone means no communication; agg_layers must be "
                    "empty (or None to derive)")
            object.__setattr__(self, "agg_layers", ())
        else:
            if self.agg_layers is None:
                k = self.k if self.k is not None else max(self.n_layers // 2, 1)
                object.__setattr__(self, "agg_layers",
                                   agg_layers_for_k(self.n_layers, k))
            else:
                object.__setattr__(self, "agg_layers",
                                   tuple(sorted(set(self.agg_layers))))

        if self.k is not None and self.agg_layers and \
                len(self.agg_layers) != self.k:
            err(f"k={self.k} inconsistent with explicit agg_layers="
                f"{self.agg_layers}")
        if self.agg_layers:
            if any(l < 0 or l >= self.n_layers for l in self.agg_layers):
                err(f"agg_layers {self.agg_layers} out of range for "
                    f"n_layers={self.n_layers}")
            if (self.n_layers - 1) not in self.agg_layers:
                err("missing prediction-layer aggregation: the input of the "
                    f"classifier (layer {self.n_layers - 1}) must be in "
                    "agg_layers (paper §3.1)")
        if self.labels_at_client is not None and not (
                0 <= self.labels_at_client < self.model_clients):
            err(f"labels_at_client={self.labels_at_client} out of range for "
                f"{self.model_clients} model clients")
        if self.backend == "simulation":
            if self.agg != "mean":
                err("SimulationBackend implements mean aggregation only")
            if self.secure_agg or self.dp_sigma > 0.0:
                err("SimulationBackend does not implement the §3.6 privacy "
                    "hooks; use the vmapped backend")
        if self.mesh_devices is not None:
            if self.backend != "sharded":
                err("mesh_devices is only meaningful for the sharded backend")
            if self.mesh_devices < 1:
                err("mesh_devices must be >= 1")
        if self.backend == "sharded":
            if self.labels_at_client is not None:
                err("ShardedBackend does not implement labels_at_client "
                    "(Alg 6 owner gradient indexes the global client axis); "
                    "use the vmapped backend")
            if self.optimizer == "adafactor":
                err("ShardedBackend does not support adafactor: factored "
                    "second moments reduce across the client-stacked dim")

    # --------------------------------------------------------------- derived
    @property
    def model_clients(self) -> int:
        """Number of clients the *model* runs with (centralized => M=1)."""
        return 1 if self.method == "centralized" else self.n_clients

    @property
    def sampler_agg_layers(self) -> Tuple[int, ...]:
        """Standalone still needs a shared mini-batch S[L] (Alg 2)."""
        return self.agg_layers if self.agg_layers else (self.n_layers - 1,)

    @property
    def resolved_fanout(self) -> int:
        """fedbcd keeps only the self loop — A(E_m) = I (§3.5)."""
        return 0 if self.method == "fedbcd" else self.fanout

    @property
    def resolved_eval_mode(self) -> str:
        if self.eval_mode is not None:
            return self.eval_mode
        return "per_client" if self.method == "standalone" else "ensemble"

    def glasu_config(self, data) -> GlasuConfig:
        """Bind to a dataset: derives d_in / n_classes, checks client
        counts."""
        if data.n_clients != self.model_clients:
            raise ValueError(
                f"ExperimentConfig {self.name!r}: mismatched n_clients — "
                f"config expects {self.model_clients} model clients, dataset "
                f"{data.name!r} has {data.n_clients}")
        return GlasuConfig(
            n_clients=self.model_clients, n_layers=self.n_layers,
            hidden=self.hidden, n_classes=data.n_classes,
            d_in=max(c.feat_dim for c in data.clients),
            backbone=self.backbone, agg=self.agg, agg_layers=self.agg_layers,
            n_local_steps=self.n_local_steps, gcnii_alpha=self.gcnii_alpha,
            gcnii_beta=self.gcnii_beta, gat_heads=self.gat_heads,
            dp_sigma=self.dp_sigma, secure_agg=self.secure_agg,
            labels_at_client=self.labels_at_client,
            use_pallas=self.use_pallas, compression=self.compression,
            fault_tolerant=self.faults is not None)

    def sampler_config(self) -> SamplerConfig:
        return SamplerConfig(
            n_layers=self.n_layers, agg_layers=self.sampler_agg_layers,
            batch_size=self.batch_size, fanout=self.resolved_fanout,
            size_cap=self.size_cap, table_cap=self.table_cap)

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            rounds=self.rounds, lr=self.lr, optimizer=self.optimizer,
            eval_every=self.eval_every, eval_table_cap=self.eval_table_cap,
            seed=self.seed, eval_mode=self.resolved_eval_mode)

    def make_optimizer(self) -> opt_lib.Optimizer:
        return opt_lib.make_optimizer(self.optimizer, self.lr)

    # ------------------------------------------------------------- interface
    def with_(self, **kw) -> "ExperimentConfig":
        """Functional update (re-runs validation). Changing ``method``,
        ``k`` or ``n_layers`` re-derives the aggregation schedule unless
        ``agg_layers`` is given in the same call."""
        if ({"method", "k", "n_layers"} & kw.keys()) and "agg_layers" not in kw:
            kw["agg_layers"] = None
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)           # nested dataclasses -> dicts
        if d["agg_layers"] is not None:
            d["agg_layers"] = list(d["agg_layers"])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"ExperimentConfig.from_dict: unknown fields "
                             f"{sorted(unknown)}")
        if d.get("agg_layers") is not None:
            d["agg_layers"] = tuple(d["agg_layers"])
        return cls(**d)

    @classmethod
    def from_legacy(cls, model_cfg: GlasuConfig, sampler_cfg: SamplerConfig,
                    train_cfg: TrainConfig, target_acc: Optional[float] = None,
                    dataset: str = "custom") -> "ExperimentConfig":
        """Adapt the three-config surface of ``core.train.train_glasu``:
        the schedules compared as sorted sets, ``method="standalone"`` when
        the model aggregates nowhere, and any optimizer name other than
        sgd / momentum / adam read as adam."""
        agg_layers = tuple(sorted(set(model_cfg.agg_layers)))
        sampler_agg = tuple(sorted(set(sampler_cfg.agg_layers)))
        want = agg_layers if agg_layers else (model_cfg.n_layers - 1,)
        if sampler_agg != want:
            # standalone included: the sampler may only share the mini-batch
            raise ValueError(
                f"mismatched agg_layers: model {tuple(model_cfg.agg_layers)} "
                f"implies sampler {want}, got {tuple(sampler_cfg.agg_layers)}")
        if model_cfg.n_layers != sampler_cfg.n_layers:
            raise ValueError(
                f"mismatched n_layers: model {model_cfg.n_layers} vs sampler "
                f"{sampler_cfg.n_layers}")
        return cls(
            name=f"legacy-{dataset}", dataset=dataset,
            method="standalone" if not agg_layers else "glasu",
            n_clients=model_cfg.n_clients, n_layers=model_cfg.n_layers,
            hidden=model_cfg.hidden, backbone=model_cfg.backbone,
            agg=model_cfg.agg, agg_layers=agg_layers or None,
            n_local_steps=model_cfg.n_local_steps,
            gcnii_alpha=model_cfg.gcnii_alpha,
            gcnii_beta=model_cfg.gcnii_beta, gat_heads=model_cfg.gat_heads,
            dp_sigma=model_cfg.dp_sigma, secure_agg=model_cfg.secure_agg,
            labels_at_client=model_cfg.labels_at_client,
            use_pallas=model_cfg.use_pallas,
            batch_size=sampler_cfg.batch_size, fanout=sampler_cfg.fanout,
            size_cap=sampler_cfg.size_cap, table_cap=sampler_cfg.table_cap,
            rounds=train_cfg.rounds, lr=train_cfg.lr,
            optimizer=legacy_optimizer_name(train_cfg.optimizer),
            eval_every=train_cfg.eval_every,
            eval_table_cap=train_cfg.eval_table_cap, seed=train_cfg.seed,
            eval_mode=train_cfg.eval_mode, target_acc=target_acc)
