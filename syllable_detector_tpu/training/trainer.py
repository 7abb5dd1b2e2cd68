"""Train syllable-detector MLPs on an accelerator.

Replaces the reference's MATLAB pipeline: compute the same spectrogram
features the detector consumes at inference time (hop-strided hamming band
DFT magnitudes, stacked over timeRange frames — exactly
Common/SyllableDetector.swift:153-217), fit the MATLAB-style mapminmax input
mapping (convert_to_text.m:118-182), then train the tansig/purelin MLP with
optax against [0, 1] syllable labels. The trained net exports through
config.save_config to the same text format MATLAB's exporter writes
(convert_to_text.m:59-214), so the reference Swift app can load nets trained
here.

Data parallelism: shard the (features, labels) batch across a mesh axis and
``psum`` gradients — the standard dp recipe; an optional channel axis trains
independent per-channel nets side by side (stacked parameter pytrees), the
ensemble analogue of the reference's one-net-per-channel deployment.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from syllable_detector_tpu.config.model_format import (
    LayerSpec,
    ProcessingSpec,
    SyllableDetectorConfig,
    first_output_sample,
)
from syllable_detector_tpu.models.detector import WINDOW
from syllable_detector_tpu.models.neural_net import (
    NetSpec,
    apply_net,
    stack_params,
)
from syllable_detector_tpu.ops.processing import specs_to_chain
from syllable_detector_tpu.ops.scaling import apply_scaling
from syllable_detector_tpu.ops.stft import (
    frame_signal,
    frequency_index_range,
    num_frames,
    spectral_frames,
    stack_features,
)

__all__ = [
    "TrainSettings",
    "features_and_labels",
    "fit_input_chain",
    "fit_mapminmax",
    "fit_mapstd",
    "init_layer_params",
    "train",
    "train_ensemble",
    "train_step",
    "make_ensemble_epoch",
    "export_trained_config",
]


@dataclass
class TrainSettings:
    """Spectrogram + net hyperparameters (the convert_to_text.m preamble:
    samplerate/FFT_SIZE/freq_range/time_window, convert_to_text.m:23-66)."""

    sampling_rate: float = 44100.0
    fourier_length: int = 256
    window_length: int = 256
    window_overlap: int = 124
    freq_range: tuple[float, float] = (2000.0, 7000.0)
    time_range: int = 10
    scaling: str = "linear"
    # input processing chain to fit and export (convert_to_text.m:118-182:
    # the exporter emits arbitrary prepended parameter-free names followed
    # by the net's fitted processFcns — mapminmax or mapstd). Parameter-free
    # stages (l2normalize/normalize/normalizestd/passthrough) must precede
    # the fitted affine stages, matching the exporter's prepend semantics
    # and the constant-folding form (ops/processing.py
    # fold_input_affines: affines after an optional normalizer).
    input_processing: tuple[str, ...] = ("l2normalize", "mapminmax")
    hidden: tuple[int, ...] = (4,)
    learning_rate: float = 1e-3
    epochs: int = 200
    batch_size: int = 4096
    seed: int = 0
    # independent weight inits trained side by side (vmapped); the best by
    # full-data loss is kept. The tiny MLP has a mean-prediction plateau
    # (hidden units initialized too alike never differentiate) that traps
    # a substantial fraction of random inits — restarts make training
    # deterministic-ish in practice, like MATLAB operators re-running
    # train until the net "took".
    n_init: int = 4

    def __post_init__(self):
        # the MATLAB exporter's preamble validation (convert_to_text.m:41-54)
        if self.fourier_length & (self.fourier_length - 1):
            raise ValueError(
                f"fourier_length must be a power of 2, got {self.fourier_length}"
            )
        if self.window_length > self.fourier_length:
            raise ValueError(
                f"window_length ({self.window_length}) must not exceed "
                f"fourier_length ({self.fourier_length})"
            )
        if self.scaling not in ("linear", "log", "db"):
            raise ValueError(f"unknown scaling {self.scaling!r}")
        if self.time_range < 1:
            raise ValueError("time_range must be >= 1")
        self.input_processing = tuple(self.input_processing)
        free = ("l2normalize", "normalize", "normalizestd", "passthrough")
        fitted = ("mapminmax", "mapstd")
        seen_fitted = False
        for name in self.input_processing:
            if name in fitted:
                seen_fitted = True
            elif name in free:
                if seen_fitted:
                    raise ValueError(
                        f"parameter-free stage {name!r} must precede the "
                        f"fitted affine stages in input_processing "
                        f"{self.input_processing!r} (the exporter prepends "
                        "them before the net's processFcns)"
                    )
            else:
                raise ValueError(
                    f"unknown input processing function {name!r}; expected "
                    f"one of {free + fitted}"
                )

    @property
    def bins(self) -> tuple[int, int]:
        b = frequency_index_range(
            self.fourier_length, self.freq_range[0], self.freq_range[1],
            self.sampling_rate,
        )
        if b is None:
            raise ValueError("The frequency range is invalid.")
        return b

    @property
    def n_features(self) -> int:
        lo, hi = self.bins
        return (hi - lo) * self.time_range


def features_and_labels(
    settings: TrainSettings,
    audio: np.ndarray,
    intervals: list[tuple[float, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """Audio + labeled syllable intervals (seconds) -> (features [E, D],
    labels [E] in {0, 1}).

    An evaluation is positive when its decision sample (the reference's
    sample accounting, TrackDetector.swift:38-42) falls inside an interval.
    """
    audio = np.asarray(audio, np.float32).reshape(-1)
    f = num_frames(len(audio), settings.window_length, settings.window_overlap)
    frames = frame_signal(
        jnp.asarray(audio), f, settings.window_length, settings.window_overlap
    )
    band = spectral_frames(
        frames,
        settings.fourier_length,
        window_type=WINDOW,
        bins=settings.bins,
        kind="magnitude",
    )
    # apply the configured spectrogram scaling so training features match
    # what detect_features sees at inference (SyllableDetector.swift:183-212).
    # Training only: floor exact-zero magnitudes first — digitally silent
    # windows (zero-padded / gated recordings) would make log/db emit -inf
    # and make l2normalize divide 0/0 under linear scaling, either of which
    # poisons the mapminmax fit and every gradient after it. Inference keeps
    # the reference's raw semantics; a silent window never fires either way.
    stacked = jnp.maximum(stack_features(band, settings.time_range), 1e-12)
    feats = np.asarray(apply_scaling(stacked, settings.scaling))

    hop = settings.window_length - settings.window_overlap
    first = first_output_sample(
        settings.window_length, settings.window_overlap, settings.time_range
    )
    decision_samples = first + hop * np.arange(len(feats))
    t = decision_samples / settings.sampling_rate
    labels = np.zeros(len(feats), np.float32)
    for lo, hi in intervals:
        labels[(t >= lo) & (t <= hi)] = 1.0
    return feats, labels


def fit_mapminmax(features: np.ndarray) -> ProcessingSpec:
    """MATLAB mapminmax fit: per-feature map of [xmin, xmax] -> [-1, 1]
    (gains = 2/(xmax - xmin), xOffsets = xmin, yMin = -1;
    NeuralNet.swift:111-131). Zero-range features get gain 1."""
    xmin = features.min(axis=0).astype(np.float64)
    xmax = features.max(axis=0).astype(np.float64)
    rng = xmax - xmin
    gains = np.where(rng > 0, 2.0 / np.where(rng > 0, rng, 1.0), 1.0)
    return ProcessingSpec(
        name="mapminmax",
        x_offsets=xmin.astype(np.float32),
        gains=gains.astype(np.float32),
        y_offset=-1.0,
    )


def fit_mapstd(features: np.ndarray) -> ProcessingSpec:
    """MATLAB mapstd fit: per-feature map to mean 0, std 1
    (gains = ystd/xstd with ystd = 1 and the N-1 sample std MATLAB's
    std() computes, xOffsets = mean, yMean = 0; applied exactly as
    NeuralNet.swift:162-168). Zero-variance features get gain 1,
    mirroring :func:`fit_mapminmax`'s zero-range rule."""
    mean = features.mean(axis=0, dtype=np.float64)
    n = len(features)
    std = (
        features.std(axis=0, ddof=1, dtype=np.float64)
        if n > 1
        else np.zeros_like(mean)
    )
    gains = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    return ProcessingSpec(
        name="mapstd",
        x_offsets=mean.astype(np.float32),
        gains=gains.astype(np.float32),
        y_offset=0.0,
    )


def fit_input_chain(
    settings: TrainSettings, features: np.ndarray
) -> tuple[list[ProcessingSpec], np.ndarray]:
    """Fit ``settings.input_processing`` sequentially: each fitted affine
    stage (mapminmax/mapstd) is fit on the features as transformed by the
    stages before it — MATLAB configures process settings the same way
    (each processFcn sees the previous one's output). Returns the fitted
    specs and the fully transformed features."""
    from syllable_detector_tpu.ops.processing import apply_named

    specs: list[ProcessingSpec] = []
    for name in settings.input_processing:
        if name == "mapminmax":
            spec = fit_mapminmax(features)
        elif name == "mapstd":
            spec = fit_mapstd(features)
        else:
            spec = ProcessingSpec(name)
        p = specs_to_chain([spec])[1][0]
        features = np.asarray(apply_named(jnp.asarray(features), name, p))
        specs.append(spec)
    return specs, features


def init_layer_params(
    key, sizes: list[int], scale: float = 2.0
) -> list[dict]:
    """Uniform init, bounds ``scale/sqrt(fan_in)`` (weights) and ``scale``
    (biases). Default scale 2.0 measured: at 0.5 the hidden tansig units
    start near-identical and ~5/6 of inits collapse onto the
    mean-prediction plateau (loss == label variance, zero separation);
    at 2.0 ~5/6 converge — the Nguyen-Widrow idea of spreading the
    units' active regions, done by magnitude."""
    params = []
    for i in range(len(sizes) - 1):
        key, k1, k2 = jax.random.split(key, 3)
        fan_in = sizes[i]
        bound = scale / np.sqrt(fan_in)
        w = jax.random.uniform(
            k1, (sizes[i + 1], sizes[i]), jnp.float32, -bound, bound
        )
        b = jax.random.uniform(k2, (sizes[i + 1],), jnp.float32, -scale, scale)
        params.append({"w": w, "b": b})
    return params


def _build_net_spec(settings: TrainSettings) -> NetSpec:
    sizes = [settings.n_features, *settings.hidden, 1]
    transfers = tuple(["TanSig"] * len(settings.hidden) + ["PureLin"])
    return NetSpec(
        layer_sizes=tuple((sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)),
        transfers=transfers,
        input_processing=settings.input_processing,
        output_processing=("mapminmax",),
    )


def _loss_fn(net_spec: NetSpec, params, feats, labels):
    preds = apply_net(net_spec, params, feats)[..., 0]
    return jnp.mean((preds - labels) ** 2)


@partial(jax.jit, static_argnames=("net_spec", "lr"))
def train_step(net_spec: NetSpec, params, opt_state, feats, labels, lr=1e-3):
    """One SGD/adam step on the layer weights (processing params frozen)."""
    opt = optax.adam(lr)

    def loss(layer_params):
        p = dict(params, layers=layer_params)
        return _loss_fn(net_spec, p, feats, labels)

    value, grads = jax.value_and_grad(loss)(params["layers"])
    updates, opt_state = opt.update(grads, opt_state, params["layers"])
    layers = optax.apply_updates(params["layers"], updates)
    return dict(params, layers=layers), opt_state, value


def _make_restart_epoch(
    net_spec: NetSpec,
    lr: float,
    mesh: Mesh | None = None,
    data_axis: str = "data",
):
    """One whole EPOCH as a single device program: ``lax.scan`` over the
    steps, each gathering its batch on device from the resident feature
    array — the host sends one [S, bs] index array per epoch instead of
    dispatching every optimizer step (one device program per epoch, not
    one launch round trip per step).

    K stacked weight inits share every batch (vmapped — restarts cost
    one wider program, not K sequential runs). Without a mesh the batch
    is local; with one, the [S, bs] indices shard over ``data_axis``
    (each device gathers its rows from the replicated features) and
    per-init grads are pmean-averaged across devices (dp), params
    replicated."""
    opt = optax.adam(lr)

    def stacked_step(params, opt_state, feats, labels):
        def grads_one(p):
            def loss(layer_params):
                return _loss_fn(
                    net_spec, dict(p, layers=layer_params), feats, labels
                )

            return jax.value_and_grad(loss)(p["layers"])

        values, grads = jax.vmap(grads_one)(params)
        if mesh is not None:
            grads = jax.lax.pmean(grads, data_axis)
            values = jax.lax.pmean(values, data_axis)
        # opt_state is per-init (vmap(opt.init)) so every leaf — adam's
        # step count included — carries the stacked leading dim; the
        # update vmaps over it (bias corrections stay per init)
        updates, opt_state = jax.vmap(opt.update)(
            grads, opt_state, params["layers"]
        )
        layers = optax.apply_updates(params["layers"], updates)
        return dict(params, layers=layers), opt_state, values

    def epoch(params, opt_state, feats, labels, idx):
        # feats [n, D] resident on device; idx [S, bs_local] int32
        def body(carry, idx_s):
            params, opt_state = carry
            params, opt_state, values = stacked_step(
                params, opt_state, feats[idx_s], labels[idx_s]
            )
            return (params, opt_state), values

        (params, opt_state), values = jax.lax.scan(
            body, (params, opt_state), idx
        )
        return params, opt_state, values  # values [S, K]

    if mesh is None:
        return jax.jit(epoch)
    return jax.jit(
        jax.shard_map(
            epoch,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(None, data_axis)),
            out_specs=(P(), P(), P()),
        )
    )


def _save_train_state(directory: str, epoch: int, params, opt_state) -> None:
    from syllable_detector_tpu.training.checkpoint import save_checkpoint

    save_checkpoint(
        directory,
        epoch,
        {
            "params": jax.tree.map(np.asarray, params),
            "opt_state": jax.tree.map(np.asarray, opt_state),
        },
    )


def _maybe_resume(directory: str, params, opt_state):
    """Restore (params, opt_state, epochs_completed) from the latest
    checkpoint in ``directory`` (typed containers restore into the live
    templates), or return the inputs unchanged with epoch 0."""
    from syllable_detector_tpu.training.checkpoint import (
        latest_step,
        restore_checkpoint,
    )

    step = latest_step(directory)
    if step is None:
        return params, opt_state, 0
    state = restore_checkpoint(
        directory, step, template={"params": params, "opt_state": opt_state}
    )
    return state["params"], state["opt_state"], step


def _check_fingerprint(directory: str, fingerprint: dict) -> None:
    """Claim a checkpoint directory for THIS training configuration.

    A checkpoint is only a valid resume point for the run that produced
    it: silently adopting a stale directory (different data, seed,
    geometry, or single-vs-ensemble mode) would train a chimera while
    claiming a bit-exact resume. The fingerprint (everything defining the
    batch sequence except ``epochs`` — extending a finished run IS the
    legit use) is stored as JSON on first use and must match afterwards.
    """
    from syllable_detector_tpu.training.checkpoint import _checkpointer

    _checkpointer()  # no orbax: fail before training, not at the first save
    fingerprint = json.loads(json.dumps(fingerprint))  # normalize tuples
    path = os.path.join(directory, "fingerprint.json")
    if os.path.exists(path):
        try:
            with open(path) as fh:
                saved = json.load(fh)
        except (OSError, ValueError) as e:
            raise ValueError(
                f"checkpoint directory {directory!r} has an unreadable "
                f"fingerprint.json ({e}); the directory predates this run "
                f"or was corrupted — use a fresh directory"
            ) from e
        if saved != fingerprint:
            diff = {
                k: (saved.get(k), fingerprint.get(k))
                for k in set(saved) | set(fingerprint)
                if saved.get(k) != fingerprint.get(k)
            }
            raise ValueError(
                f"checkpoint directory {directory!r} belongs to a different "
                f"training run (mismatched {sorted(diff)}); use a fresh "
                f"directory"
            )
    else:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(fingerprint, fh)
        os.replace(tmp, path)  # atomic: a crash mid-write can't brick the dir


def _data_fingerprint(features: np.ndarray, labels: np.ndarray) -> list:
    """Order-sensitive, copy-free content fingerprint of one channel's
    (features, labels). Plain float64 sums catch value changes;
    row-index-weighted sums catch reorderings and label flips that leave
    the totals unchanged (a permutation-invariant sum let a run silently
    resume after its labels were inverted — same audio, same feature sum).
    No float64 copy of the data is materialized: the per-row reduction and
    the dot run in float64 accumulators over the float32 rows."""
    rows = np.sum(features, axis=1, dtype=np.float64)  # [n]
    w = np.arange(1.0, len(rows) + 1.0)
    labs = np.asarray(labels, np.float64)
    return [
        float(rows.sum()),
        float(np.dot(rows, w)),
        float(labs.sum()),
        float(np.dot(labs, w)),
    ]


def _save_rng_state(directory: str, epoch: int, rngs: list) -> None:
    """Persist the epoch rngs' bit-generator states next to the orbax step
    so resume is O(1) instead of re-drawing every completed epoch's index
    tensor (a 10k-epoch x 1M-row run would spend minutes of host time per
    resume on discarded ``rng.permutation`` draws)."""
    path = os.path.join(directory, f"rng_{epoch:08d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump([r.bit_generator.state for r in rngs], fh)
    os.replace(tmp, path)  # atomic: readers only ever see a complete file


def _restore_rng_state(directory: str, epoch: int, rngs: list) -> bool:
    """Restore the rng states saved at ``epoch``; False (caller falls back
    to draw-and-discard fast-forward) if absent or mismatched."""
    path = os.path.join(directory, f"rng_{epoch:08d}.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as fh:
            states = json.load(fh)
    except (OSError, ValueError):
        # corrupt/unreadable sidecar: the draw-and-discard fast-forward
        # reproduces the exact same states, just slower — never abort
        return False
    if len(states) != len(rngs):
        return False
    for r, s in zip(rngs, states):
        r.bit_generator.state = s
    return True


# stacked per-epoch index tensors are capped at this size per device
# program (keeps host+HBM index memory bounded on huge datasets)
_INDEX_BUDGET_BYTES = 64 << 20


def _run_training_loop(
    settings: TrainSettings,
    epoch_fn,
    data: tuple,
    epoch_indices,
    params,
    opt_state,
    verbose: bool,
    checkpoint_dir: str | None,
    checkpoint_every: int,
    print_fn,
    fingerprint: dict,
    rngs: list,
):
    """The shared epoch driver for train()/train_ensemble().

    Dispatch structure: as many epochs as possible run per device program
    (their [S, ...] index tensors concatenate; the batch sequence is
    bit-identical however the epochs are chunked — pinned by the
    quiet-vs-verbose test), bounded by the verbose print cadence (1), the
    checkpoint interval, and ``_INDEX_BUDGET_BYTES``. ``rngs`` are the
    generators ``epoch_indices`` draws from: their states checkpoint
    alongside the orbax step for O(1) resume, with draw-and-discard
    fast-forward (``epoch_indices()`` without using the result) as the
    fallback when the rng sidecar is missing.
    """
    if checkpoint_dir is not None and checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    start_epoch = 0
    if checkpoint_dir is not None:
        _check_fingerprint(checkpoint_dir, fingerprint)
        params, opt_state, start_epoch = _maybe_resume(
            checkpoint_dir, params, opt_state
        )
        if start_epoch > settings.epochs:
            raise ValueError(
                f"checkpoint at epoch {start_epoch} is beyond "
                f"settings.epochs={settings.epochs}; raise epochs to "
                f"continue or use a fresh directory"
            )
        if start_epoch and not _restore_rng_state(
            checkpoint_dir, start_epoch, rngs
        ):
            for _ in range(start_epoch):  # fast-forward the epoch rng
                epoch_indices()
        if verbose and start_epoch:
            print(f"resumed from checkpoint at epoch {start_epoch}")

    epoch = start_epoch
    cap = None  # epochs per program under the index budget (lazy: needs one draw)
    while epoch < settings.epochs:
        first = epoch_indices()
        if cap is None:
            cap = max(1, _INDEX_BUDGET_BYTES // max(1, first.nbytes))
        k = 1 if verbose else min(cap, settings.epochs - epoch)
        if checkpoint_dir is not None:
            k = min(k, checkpoint_every - epoch % checkpoint_every)
        idx = (
            np.concatenate([first] + [epoch_indices() for _ in range(k - 1)])
            if k > 1
            else first
        )
        params, opt_state, values = epoch_fn(
            params, opt_state, *data, jnp.asarray(idx, jnp.int32)
        )
        epoch += k
        if verbose and (
            (epoch - 1) % 25 == 0 or epoch == settings.epochs
        ):
            print_fn(epoch - 1, values)
        if checkpoint_dir is not None and (
            epoch % checkpoint_every == 0 or epoch == settings.epochs
        ):
            _save_train_state(checkpoint_dir, epoch, params, opt_state)
            _save_rng_state(checkpoint_dir, epoch, rngs)
    return params, opt_state


def train(
    settings: TrainSettings,
    features: np.ndarray,
    labels: np.ndarray,
    mesh: Mesh | None = None,
    verbose: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
):
    """Full training loop -> (net_spec, params, threshold).

    The output mapminmax (gain 2, yMin -1) maps net outputs from [-1, 1] to
    [0, 1] probabilities, like MATLAB's exported nets (sample.txt:17-20);
    training therefore fits apply_net's post-chain output directly to the
    0/1 labels. ``settings.n_init`` independent weight inits train side by
    side in one vmapped program and the best by full-data loss is kept
    (see :class:`TrainSettings`). The detection threshold is picked by
    maximizing Youden's J (recall minus false-alarm rate) over a grid of
    score quantiles (:func:`_pick_threshold`). With ``mesh``, batches
    shard over its first axis (dp) and grads are pmean-averaged.

    Dispatch structure: epochs run as device programs (``lax.scan`` over
    the steps, batches gathered on device); quietly they chunk as many
    epochs per program as the checkpoint interval and a 64 MiB index
    budget allow (typically the whole run), verbose prints force one
    epoch per program — the batch sequence is bit-identical however the
    epochs are chunked.

    With ``checkpoint_dir``, (params, opt_state) checkpoint every
    ``checkpoint_every`` epochs (orbax) and an interrupted run RESUMES
    from the latest checkpoint bit-exactly (the epoch rng fast-forwards
    past completed epochs). The directory is fingerprinted to the run's
    configuration and data; reusing it for a different run raises.
    """
    if len(features) == 0:
        raise ValueError("features has no rows")
    net_spec = _build_net_spec(settings)
    in_specs, _ = fit_input_chain(settings, features)
    mm_out = ProcessingSpec(
        name="mapminmax",
        x_offsets=np.zeros(1, np.float32),
        gains=np.full(1, 2.0, np.float32),
        y_offset=-1.0,
    )
    _, in_params = specs_to_chain(in_specs)
    _, out_params = specs_to_chain([mm_out])

    key = jax.random.PRNGKey(settings.seed)
    sizes = [settings.n_features, *settings.hidden, 1]
    K = max(1, settings.n_init)
    params = stack_params(
        [
            {
                "layers": init_layer_params(jax.random.fold_in(key, i), sizes),
                "process_inputs": in_params,
                "process_outputs": out_params,
            }
            for i in range(K)
        ]
    )

    opt = optax.adam(settings.learning_rate)
    opt_state = jax.vmap(opt.init)(params["layers"])  # per-init state

    n = len(features)
    feats = jnp.asarray(features, jnp.float32)
    labs = jnp.asarray(labels, jnp.float32)
    bs = min(settings.batch_size, n)
    if mesh is not None:
        n_dev = mesh.devices.size
        if n < n_dev:
            raise ValueError(
                f"{n} feature rows cannot shard over {n_dev} devices; "
                f"use a smaller mesh or more data"
            )
        bs = (bs // n_dev) * n_dev or n_dev
        # place the dataset in the epoch program's replicated layout ONCE —
        # otherwise every epoch call re-broadcasts it from device 0 (each
        # device gathers its own batch rows locally, so replication is the
        # price of device-resident gathers; fine for song-scale datasets)
        feats = jax.device_put(feats, NamedSharding(mesh, P()))
        labs = jax.device_put(labs, NamedSharding(mesh, P()))
    epoch_fn = _make_restart_epoch(
        net_spec,
        settings.learning_rate,
        mesh=mesh,
        data_axis=mesh.axis_names[0] if mesh is not None else "data",
    )
    steps = n // bs  # one epoch = one device program of this many steps

    rng = np.random.default_rng(settings.seed)

    def epoch_indices():
        return (
            rng.permutation(n)[: steps * bs].reshape(steps, bs)
            .astype(np.int32)
        )

    fingerprint = {
        "mode": "single",
        "settings": {
            k: v for k, v in asdict(settings).items() if k != "epochs"
        },
        "n": int(n),
        "bs": int(bs),
        "mesh": list(mesh.shape.items()) if mesh is not None else None,
        "data": _data_fingerprint(features, labels),
    }

    def print_fn(epoch, values):
        print(
            f"epoch {epoch}: loss {np.asarray(values).mean(0).min():.5f} "
            f"(best of {K} inits)"
        )

    params, opt_state = _run_training_loop(
        settings, epoch_fn, (feats, labs), epoch_indices, params, opt_state,
        verbose, checkpoint_dir, checkpoint_every, print_fn, fingerprint,
        [rng],
    )

    full = jax.vmap(lambda p: _loss_fn(net_spec, p, feats, labs))(params)
    best = int(np.argmin(np.asarray(full)))
    params = jax.tree.map(lambda x: x[best], params)
    preds = np.asarray(apply_net(net_spec, params, feats)[..., 0])
    threshold = _pick_threshold(preds, labels)
    return net_spec, params, threshold


def make_ensemble_epoch(
    net_spec: NetSpec,
    lr: float,
    n_init: int = 1,
    mesh: Mesh | None = None,
    channel_axis: str = "channel",
):
    """One EPOCH of a CHANNEL-STACKED ensemble of independent nets as a
    single device program — the training-side counterpart of the live
    bank's per-channel distinct networks (the reference trains one
    MATLAB net per audio channel, Processor.swift:57-59; here all of
    them train together, and a whole epoch of steps runs in one
    ``lax.scan`` with per-step batches gathered ON DEVICE from the
    resident [C, n_max, D] feature stack — the host sends one
    [S, C, bs] index array per epoch instead of dispatching every step).

    Stacked pytrees carry a flat leading ``C * n_init`` dim on every leaf
    ([C*K, out, in] weights, channel-major: flat index ``c*K + k``);
    every init of a channel shares the channel's batch (broadcast inside
    the step, so no K-fold batch copy exists anywhere). Adam updates the
    stack elementwise (adam is elementwise, so this is exactly C*K
    independent optimizers). With ``mesh``, channels shard over
    ``channel_axis`` via ``shard_map`` — no collectives cross channels
    (the nets are independent), so scaling is embarrassingly parallel
    over ICI; C must divide the axis size so every device holds whole
    channels (all K inits of a channel together).
    """
    opt = optax.adam(lr)
    K = max(1, n_init)

    def grads_one(params, feats, labels):
        def loss(layer_params):
            p = dict(params, layers=layer_params)
            return _loss_fn(net_spec, p, feats, labels)

        return jax.value_and_grad(loss)(params["layers"])

    def channel_step(p_c, o_c, f_c, l_c):
        # p_c: one channel's K stacked inits; f_c/l_c: its shared batch
        values, grads = jax.vmap(lambda p: grads_one(p, f_c, l_c))(p_c)
        # per-init opt_state (vmap(opt.init)): every leaf, adam's step
        # count included, has the leading init dim — keeps bias
        # corrections per init
        updates, o_c = jax.vmap(opt.update)(grads, o_c, p_c["layers"])
        layers = optax.apply_updates(p_c["layers"], updates)
        return dict(p_c, layers=layers), o_c, values

    def fold(t):  # [C*K, ...] -> [C, K, ...] (free: a reshape view)
        return jax.tree.map(
            lambda x: x.reshape(x.shape[0] // K, K, *x.shape[1:]), t
        )

    def flat(t):  # [C, K, ...] -> [C*K, ...]
        return jax.tree.map(
            lambda x: x.reshape(x.shape[0] * K, *x.shape[2:]), t
        )

    def epoch(params, opt_state, feats_all, labs_all, idx):
        # params: flat [C*K, ...] stacked pytree; feats_all [C, n_max, D]
        # resident on device; idx [S, C, bs] int32 (each row within its
        # channel's true length — padding rows are never indexed)
        def body(carry, idx_s):
            params, opt_state = carry
            fb = jnp.take_along_axis(feats_all, idx_s[..., None], axis=1)
            lb = jnp.take_along_axis(labs_all, idx_s, axis=1)
            p2, o2, values = jax.vmap(channel_step)(
                fold(params), fold(opt_state), fb, lb
            )
            return (flat(p2), flat(o2)), values.reshape(-1)

        (params, opt_state), values = jax.lax.scan(
            body, (params, opt_state), idx
        )
        return params, opt_state, values  # values [S, C*K]

    if mesh is None:
        return jax.jit(epoch)
    ax = P(channel_axis)
    return jax.jit(
        jax.shard_map(
            epoch,
            mesh=mesh,
            in_specs=(ax, ax, ax, ax, P(None, channel_axis)),
            out_specs=(ax, ax, P(None, channel_axis)),
        )
    )


def train_ensemble(
    settings: TrainSettings,
    features_list: list[np.ndarray],
    labels_list: list[np.ndarray],
    mesh: Mesh | None = None,
    channel_axis: str = "channel",
    verbose: bool = False,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
):
    """Train C independent per-channel nets in one device program ->
    (net_spec, [params_c], [threshold_c]).

    Every channel gets its own mapminmax fit, weight inits
    (``settings.n_init`` restarts per channel, best by full-data loss —
    see :class:`TrainSettings`), batch sampling, and Youden-J threshold;
    geometry (``settings``) is shared, exactly like :class:`DetectorBank`
    lanes. An epoch covers the LONGEST channel once; channels with fewer
    evaluations wrap their batch sampling (mod their own length). With
    ``mesh``, C must divide evenly over the ``channel_axis`` devices
    (every device holds whole channels — all n_init inits together).
    ``checkpoint_dir``/``checkpoint_every`` behave as in :func:`train`
    (orbax checkpoints, bit-exact resume, per-epoch dispatch).
    """
    C = len(features_list)
    K = max(1, settings.n_init)
    if C == 0 or len(labels_list) != C:
        raise ValueError("features_list and labels_list must pair one-to-one")
    for c, f in enumerate(features_list):
        if len(f) == 0:
            raise ValueError(f"channel {c} has no feature rows")
    if mesh is not None:
        n_dev = int(np.prod([mesh.shape[a] for a in (channel_axis,)]))
        if C % n_dev:
            raise ValueError(
                f"{C} channels do not shard evenly over "
                f"{n_dev} '{channel_axis}' devices"
            )
    net_spec = _build_net_spec(settings)
    mm_out = ProcessingSpec(
        name="mapminmax",
        x_offsets=np.zeros(1, np.float32),
        gains=np.full(1, 2.0, np.float32),
        y_offset=-1.0,
    )
    sizes = [settings.n_features, *settings.hidden, 1]
    per_params = []
    for c in range(C):
        if features_list[c].shape[1] != settings.n_features:
            raise ValueError(
                f"channel {c} features have {features_list[c].shape[1]} "
                f"columns, settings expect {settings.n_features}"
            )
        _, in_params = specs_to_chain(
            fit_input_chain(settings, features_list[c])[0]
        )
        _, out_params = specs_to_chain([mm_out])
        key = jax.random.fold_in(jax.random.PRNGKey(settings.seed), c)
        for k in range(K):  # flat stack index = c * K + k (channel-major)
            per_params.append(
                {
                    "layers": init_layer_params(
                        jax.random.fold_in(key, k), sizes
                    ),
                    "process_inputs": in_params,
                    "process_outputs": out_params,
                }
            )
    params = stack_params(per_params)

    opt = optax.adam(settings.learning_rate)
    opt_state = jax.vmap(opt.init)(params["layers"])  # per-init state
    epoch_fn = make_ensemble_epoch(
        net_spec,
        settings.learning_rate,
        n_init=K,
        mesh=mesh,
        channel_axis=channel_axis,
    )

    ns = [len(f) for f in features_list]
    bs = min(settings.batch_size, min(ns))
    # an epoch covers the LONGEST channel once; shorter channels wrap
    steps_per_epoch = max(1, max(ns) // bs)
    # channels stack into one device-resident [C, n_max, D] array (pad
    # rows are never indexed — every idx entry stays within its channel)
    n_max = max(ns)
    feats_all = np.zeros((C, n_max, settings.n_features), np.float32)
    labs_all = np.zeros((C, n_max), np.float32)
    for c in range(C):
        feats_all[c, : ns[c]] = features_list[c]
        labs_all[c, : ns[c]] = labels_list[c]
    if mesh is not None:
        # channel-sharded placement up front — one transfer, no per-epoch
        # reshard (each device holds only its own channels' data)
        feats_all = jax.device_put(
            feats_all, NamedSharding(mesh, P(channel_axis))
        )
        labs_all = jax.device_put(
            labs_all, NamedSharding(mesh, P(channel_axis))
        )
    else:
        feats_all = jnp.asarray(feats_all)
        labs_all = jnp.asarray(labs_all)

    rngs = [np.random.default_rng(settings.seed + c) for c in range(C)]

    def epoch_indices():
        orders = [r.permutation(n) for r, n in zip(rngs, ns)]
        return np.stack(
            [
                np.take(
                    orders[c],
                    np.arange(steps_per_epoch * bs),
                    mode="wrap",
                ).reshape(steps_per_epoch, bs)
                for c in range(C)
            ],
            axis=1,
        ).astype(np.int32)  # [S, C, bs]

    fingerprint = {
        "mode": "ensemble",
        "settings": {
            k: v for k, v in asdict(settings).items() if k != "epochs"
        },
        "ns": [int(n) for n in ns],
        "bs": int(bs),
        "mesh": list(mesh.shape.items()) if mesh is not None else None,
        "data": [
            _data_fingerprint(f, l)
            for f, l in zip(features_list, labels_list)
        ],
    }

    def print_fn(epoch, values):
        mean = np.asarray(values).mean(axis=0).reshape(C, K)
        print(
            f"epoch {epoch}: loss "
            + " ".join(f"{v:.5f}" for v in mean.min(axis=1))
            + (f" (best of {K} inits)" if K > 1 else "")
        )

    params, opt_state = _run_training_loop(
        settings, epoch_fn, (feats_all, labs_all), epoch_indices, params,
        opt_state, verbose, checkpoint_dir, checkpoint_every, print_fn,
        fingerprint, rngs,
    )

    # best init per channel by full-data loss (each channel's true prefix
    # of the padded stack)
    full = np.asarray(
        jnp.stack(
            [
                jax.vmap(
                    lambda p, c=c: _loss_fn(
                        net_spec,
                        p,
                        feats_all[c, : ns[c]],
                        labs_all[c, : ns[c]],
                    )
                )(
                    jax.tree.map(
                        lambda x, c=c: x[c * K : (c + 1) * K], params
                    )
                )
                for c in range(C)
            ]
        )
    )
    params_list, thresholds = [], []
    for c in range(C):
        best = c * K + int(np.argmin(full[c]))
        params_c = jax.tree.map(lambda x: x[best], params)
        preds = np.asarray(
            apply_net(net_spec, params_c, feats_all[c, : ns[c]])[..., 0]
        )
        params_list.append(params_c)
        thresholds.append(_pick_threshold(preds, labels_list[c]))
    return net_spec, params_list, thresholds


def _pick_threshold(preds: np.ndarray, labels: np.ndarray) -> float:
    """Maximize Youden's J (recall - false-alarm rate) over a score grid —
    robust to label noise at syllable boundaries."""
    pos = preds[labels > 0.5]
    neg = preds[labels < 0.5]
    if not len(pos) or not len(neg):
        return 0.5
    candidates = np.unique(np.quantile(preds, np.linspace(0.01, 0.99, 197)))
    best_t, best_j = 0.5, -np.inf
    for t in candidates:
        j = (pos >= t).mean() - (neg >= t).mean()
        if j > best_j:
            best_j, best_t = j, float(t)
    return min(max(best_t, 1e-3), 0.999)


def export_trained_config(
    settings: TrainSettings, net_spec: NetSpec, params, threshold: float
) -> SyllableDetectorConfig:
    """Package trained parameters into a SyllableDetectorConfig (the
    convert_to_text.m equivalent; save with config.save_config)."""
    layers = []
    for (inputs, outputs), transfer, lp in zip(
        net_spec.layer_sizes, net_spec.transfers, params["layers"]
    ):
        layers.append(
            LayerSpec(
                inputs=inputs,
                outputs=outputs,
                weights=np.asarray(lp["w"], np.float32),
                biases=np.asarray(lp["b"], np.float32),
                transfer=transfer,
            )
        )
    process_inputs = []
    for name, p in zip(net_spec.input_processing, params["process_inputs"]):
        if name not in ("mapminmax", "mapstd"):  # parameter-free stages
            process_inputs.append(ProcessingSpec(name))
        else:
            process_inputs.append(
                ProcessingSpec(
                    name,
                    x_offsets=np.asarray(p["x_offsets"], np.float32),
                    gains=np.asarray(p["gains"], np.float32),
                    y_offset=float(p["y_offset"]),
                )
            )
    process_outputs = [
        ProcessingSpec(
            "mapminmax",
            x_offsets=np.asarray(p["x_offsets"], np.float32),
            gains=np.asarray(p["gains"], np.float32),
            y_offset=float(p["y_offset"]),
        )
        for name, p in zip(net_spec.output_processing, params["process_outputs"])
    ]
    return SyllableDetectorConfig(
        sampling_rate=settings.sampling_rate,
        fourier_length=settings.fourier_length,
        window_length=settings.window_length,
        window_overlap=settings.window_overlap,
        freq_range=settings.freq_range,
        time_range=settings.time_range,
        thresholds=[threshold],
        scaling=settings.scaling,
        layers=layers,
        process_inputs=process_inputs,
        process_outputs=process_outputs,
    )
