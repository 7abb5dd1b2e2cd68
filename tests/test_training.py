"""Training pipeline: learn a detector on synthetic labeled audio, export to
the text format, and detect with the CLI path (closing the MATLAB loop)."""

import numpy as np
import pytest

from syllable_detector_tpu.config.model_format import dumps_config, loads_config
from syllable_detector_tpu.models.detector import Detector
from syllable_detector_tpu.parallel.mesh import make_mesh
from syllable_detector_tpu.training.trainer import (
    TrainSettings,
    export_trained_config,
    features_and_labels,
    fit_mapminmax,
    train,
)


from syllable_detector_tpu.utils.synth import make_labeled_audio  # shared

# (generator lives in utils/synth.py so the hardware smokes exercise the
# same data the suite pins)


@pytest.fixture(scope="module")
def settings():
    return TrainSettings(epochs=300, batch_size=256, hidden=(4,), learning_rate=3e-3, seed=1)


@pytest.fixture(scope="module")
def dataset(settings):
    audio, intervals = make_labeled_audio()
    feats, labels = features_and_labels(settings, audio, intervals)
    return audio, intervals, feats, labels


def test_features_and_labels(settings, dataset):
    audio, intervals, feats, labels = dataset
    assert feats.shape[1] == settings.n_features == 290
    assert 0 < labels.sum() < len(labels)


def test_settings_validation():
    """convert_to_text.m's preamble checks (convert_to_text.m:41-54)."""
    with pytest.raises(ValueError, match="power of 2"):
        TrainSettings(fourier_length=300)
    with pytest.raises(ValueError, match="must not exceed"):
        TrainSettings(fourier_length=256, window_length=512)
    with pytest.raises(ValueError, match="unknown scaling"):
        TrainSettings(scaling="cube")
    with pytest.raises(ValueError, match="time_range"):
        TrainSettings(time_range=0)


def test_features_apply_scaling(settings, dataset):
    """Training features must see the same spectrogram scaling inference
    applies (ADVICE r1 medium: log/db nets were fit on linear magnitudes)."""
    import dataclasses

    audio, intervals, feats_lin, _ = dataset
    log_settings = dataclasses.replace(settings, scaling="log")
    feats_log, _ = features_and_labels(log_settings, audio, intervals)
    np.testing.assert_allclose(
        feats_log, np.log(feats_lin), rtol=1e-5, atol=1e-6
    )


def test_fit_mapminmax(dataset):
    _, _, feats, _ = dataset
    mm = fit_mapminmax(feats)
    y = (feats - mm.x_offsets) * mm.gains + mm.y_offset
    assert y.min() == pytest.approx(-1.0, abs=1e-4)
    assert y.max() == pytest.approx(1.0, abs=1e-4)


def test_train_and_roundtrip(settings, dataset):
    audio, intervals, feats, labels = dataset
    net_spec, params, threshold = train(settings, feats, labels)

    cfg = export_trained_config(settings, net_spec, params, threshold)
    text = dumps_config(cfg)
    cfg2 = loads_config(text)  # byte-format round trip

    det = Detector(cfg2)
    det.append_audio_data(audio)
    outs = det.drain()

    hop = settings.window_length - settings.window_overlap
    first = settings.window_length + hop * (settings.time_range - 1)
    t = (first + hop * np.arange(len(outs))) / settings.sampling_rate
    inside = np.zeros(len(outs), bool)
    near = np.zeros(len(outs), bool)  # guard band: syllable edges count as
    for lo, hi in intervals:  # neither hits nor false alarms
        inside |= (t >= lo) & (t <= hi)
        near |= (t >= lo - 0.1) & (t <= hi + 0.1)

    score_in = outs[inside, 0].mean()
    score_out = outs[~near, 0].mean()
    assert score_in > score_out + 0.3, (score_in, score_out)

    detections = outs[:, 0] >= np.float32(cfg2.thresholds[0])
    # recall: most in-syllable evals detected; precision: few false alarms
    # well away from any syllable
    recall = detections[inside].mean()
    false_rate = detections[~near].mean()
    assert recall > 0.6, recall
    assert false_rate < 0.05, false_rate


def test_data_parallel_training_matches(settings, dataset):
    """dp over the 8-device mesh must converge like single-device."""
    audio, intervals, feats, labels = dataset
    mesh = make_mesh(8, axis="data")
    s = TrainSettings(epochs=60, batch_size=256, hidden=(4,), learning_rate=3e-3, seed=1)
    net_spec, params, threshold = train(s, feats, labels, mesh=mesh)
    from syllable_detector_tpu.models.neural_net import apply_net

    preds = np.asarray(apply_net(net_spec, params, feats)[..., 0])
    assert preds[labels > 0.5].mean() > preds[labels < 0.5].mean() + 0.2


def test_train_cli(tmp_path):
    """Full loop: WAV + label CSV -> trained net file -> CLI detection."""
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.cli import main as cli_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=3.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "labels.csv"
    labels.write_text(
        "# start,end\n" + "\n".join(f"{lo},{hi}" for lo, hi in intervals)
    )
    net = tmp_path / "net.txt"
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(net),
         "--epochs", "150", "--quiet"]
    )
    assert rc == 0 and net.exists()

    import io
    from contextlib import redirect_stdout

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_main(["-n", str(net), "-a", str(wav)])
    assert rc == 0
    lines = [l for l in buf.getvalue().splitlines() if l]
    assert len(lines) > 0
    # most detections land inside (or at the edges of) labeled syllables
    hits = 0
    for line in lines:
        t = float(line.split(",")[2])
        if any(lo - 0.1 <= t <= hi + 0.1 for lo, hi in intervals):
            hits += 1
    assert hits / len(lines) > 0.8, (hits, len(lines))


def test_train_cli_log_scaling(tmp_path):
    """--scaling log end-to-end (ADVICE r1 medium: these nets used to be fit
    on linear magnitudes but evaluated on log features — silently broken).
    A net trained on log features must actually detect its syllables."""
    import io
    from contextlib import redirect_stdout

    from syllable_detector_tpu.cli import main as cli_main
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=3.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    net = tmp_path / "net_log.txt"
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(net),
         "--epochs", "150", "--scaling", "log", "--quiet"]
    )
    assert rc == 0 and net.exists()
    assert "scaling = log" in net.read_text()

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_main(["-n", str(net), "-a", str(wav)])
    assert rc == 0
    lines = [l for l in buf.getvalue().splitlines() if l]
    assert len(lines) > 0
    # detections concentrate inside labeled syllables
    hits = 0
    for l in lines:
        t = float(l.split(",")[2])
        if any(lo - 0.05 <= t <= hi + 0.05 for lo, hi in intervals):
            hits += 1
    assert hits / len(lines) > 0.8


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp
    from syllable_detector_tpu.training.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    state = {
        "layers": [{"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(2)}],
        "step": jnp.int32(7),
    }
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, state)
    save_checkpoint(d, 12, state)
    assert latest_step(d) == 12
    restored = restore_checkpoint(d)
    np.testing.assert_array_equal(
        np.asarray(restored["layers"][0]["w"]), np.arange(6.0).reshape(2, 3)
    )
    assert restore_checkpoint(str(tmp_path / "none")) is None


def test_log_scaling_survives_digital_silence(settings):
    """Exact-zero audio regions (zero-padded/gated recordings) must not
    produce -inf log/db features: the mapminmax fit and every gradient
    after it would go NaN."""
    import dataclasses

    audio, intervals = make_labeled_audio()
    audio = audio.copy()
    audio[: len(audio) // 4] = 0.0  # digitally silent leading region
    for scaling in ("log", "db"):
        s = dataclasses.replace(settings, scaling=scaling)
        feats, labels = features_and_labels(s, audio, intervals)
        assert np.isfinite(feats).all(), scaling


def _two_channel_dataset(settings):
    """Two channels with DIFFERENT syllable timing/seeds."""
    feats, labels, audios, ivals = [], [], [], []
    for seed in (3, 9):
        audio, intervals = make_labeled_audio(seconds=3.0, seed=seed)
        f, l = features_and_labels(settings, audio, intervals)
        feats.append(f)
        labels.append(l)
        audios.append(audio)
        ivals.append(intervals)
    return feats, labels, audios, ivals


def test_train_ensemble_distinct_nets(settings):
    """C independent nets train in ONE device program (the training-side
    counterpart of the live bank's per-channel distinct networks);
    each must separate ITS channel's syllables, and the nets must differ."""
    import dataclasses

    from syllable_detector_tpu.models.neural_net import apply_net
    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(settings, epochs=150)
    feats, labels, _, _ = _two_channel_dataset(s)
    net_spec, params_list, thresholds = train_ensemble(s, feats, labels)
    assert len(params_list) == len(thresholds) == 2
    for c in range(2):
        preds = np.asarray(
            apply_net(net_spec, params_list[c], feats[c])[..., 0]
        )
        sep = preds[labels[c] > 0.5].mean() - preds[labels[c] < 0.5].mean()
        assert sep > 0.3, (c, sep)
        assert 0 < thresholds[c] < 1
    w0 = np.asarray(params_list[0]["layers"][0]["w"])
    w1 = np.asarray(params_list[1]["layers"][0]["w"])
    assert np.abs(w0 - w1).max() > 1e-3  # genuinely distinct nets


def test_train_ensemble_mesh_matches_single(settings):
    """Channel-sharded ensemble over a 2-device mesh is the SAME
    computation (no collectives cross channels): results match the
    unsharded ensemble to float tolerance."""
    import dataclasses

    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(settings, epochs=40)
    feats, labels, _, _ = _two_channel_dataset(s)
    _, single, thr_single = train_ensemble(s, feats, labels)
    mesh = make_mesh(2, axis="channel")
    _, sharded, thr_sharded = train_ensemble(s, feats, labels, mesh=mesh)
    for c in range(2):
        for ls, lm in zip(single[c]["layers"], sharded[c]["layers"]):
            np.testing.assert_allclose(
                np.asarray(ls["w"]), np.asarray(lm["w"]), rtol=1e-4, atol=1e-5
            )
        assert thr_single[c] == pytest.approx(thr_sharded[c], abs=1e-3)

    s1 = dataclasses.replace(s, n_init=1)  # 3 x 1 nets over 2 devices
    with pytest.raises(ValueError, match="shard evenly"):
        train_ensemble(
            s1, feats + feats[:1], labels + labels[:1], mesh=mesh
        )


def test_train_ensemble_cli_roundtrip(tmp_path):
    """Repeatable -a/-l pairs train per-channel nets together; each
    exported net drives the CLI and detects its own channel's syllables."""
    import io
    from contextlib import redirect_stdout

    from syllable_detector_tpu.cli import main as cli_main
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    wavs, label_files, ivals = [], [], []
    for i, seed in enumerate((3, 9)):
        audio, intervals = make_labeled_audio(seconds=3.0, seed=seed)
        wav = tmp_path / f"train{i}.wav"
        write_wav(wav, audio, 44100, dtype="float32")
        lab = tmp_path / f"labels{i}.csv"
        lab.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
        wavs.append(wav)
        label_files.append(lab)
        ivals.append(intervals)

    out = tmp_path / "net_{ch}.txt"
    rc = train_main(
        ["-a", str(wavs[0]), "-l", str(label_files[0]),
         "-a", str(wavs[1]), "-l", str(label_files[1]),
         "-o", str(out), "--epochs", "150", "--quiet"]
    )
    assert rc == 0
    nets = [tmp_path / "net_0.txt", tmp_path / "net_1.txt"]
    assert all(n.exists() for n in nets)

    for i in range(2):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli_main(["-n", str(nets[i]), "-a", str(wavs[i])])
        assert rc == 0
        lines = [l for l in buf.getvalue().splitlines() if l]
        assert lines
        hits = sum(
            1
            for l in lines
            if any(
                lo - 0.1 <= float(l.split(",")[2]) <= hi + 0.1
                for lo, hi in ivals[i]
            )
        )
        assert hits / len(lines) > 0.8


def test_train_cli_mismatched_pairs(tmp_path):
    from syllable_detector_tpu.train import main as train_main

    rc = train_main(
        ["-a", "a.wav", "-a", "b.wav", "-l", "only.csv", "-o", "x.txt"]
    )
    assert rc == 1


def test_train_cli_deep_net(tmp_path):
    """--hidden 8 4 exports a 2-hidden-layer net (the reference's
    patternnet supports arbitrary depth, convert_to_text.m writes every
    layer) that loads and detects like the NumPy oracle."""
    import numpy as np

    import reference_impl as ref
    from syllable_detector_tpu.config.model_format import load_config
    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
        offline_outputs,
    )
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=2.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    net = tmp_path / "net_deep.txt"
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(net),
         "--hidden", "8", "4", "--epochs", "40", "--quiet"]
    )
    assert rc == 0 and net.exists()

    cfg = load_config(net)
    assert [l.outputs for l in cfg.layers] == [8, 4, 1]
    spec, params = detector_spec_from_config(cfg)
    x = audio[:22050]
    got = np.asarray(offline_outputs(spec, params, x))
    np.testing.assert_allclose(
        got, ref.detect_offline(cfg, x), rtol=1e-3, atol=2e-4
    )


def test_train_checkpoint_without_orbax(tmp_path, monkeypatch, capsys):
    """orbax is optional: --checkpoint-dir without it fails up front with
    a clear message, not after training or with a traceback."""
    import sys

    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    audio, intervals = make_labeled_audio(seconds=2.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(tmp_path / "n.txt"),
         "--epochs", "2", "--quiet", "--checkpoint-dir",
         str(tmp_path / "ckpt")]
    )
    assert rc == 1
    assert "orbax" in capsys.readouterr().err


def test_train_input_validation(settings):
    """Clear ValueErrors instead of ZeroDivisionError/np.stack([]) crashes
    on degenerate inputs (review findings): empty datasets and meshes
    larger than the dataset must fail loudly, not train zero steps."""
    import dataclasses

    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(settings, epochs=1)
    empty = np.zeros((0, s.n_features), np.float32)
    with pytest.raises(ValueError, match="no rows"):
        train(s, empty, np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="channel 1 has no feature rows"):
        train_ensemble(
            s,
            [np.zeros((4, s.n_features), np.float32), empty],
            [np.zeros(4, np.float32), np.zeros(0, np.float32)],
        )
    mesh = make_mesh(8, axis="data")
    with pytest.raises(ValueError, match="cannot shard over 8 devices"):
        train(
            s,
            np.zeros((5, s.n_features), np.float32),
            np.zeros(5, np.float32),
            mesh=mesh,
        )


def test_train_ensemble_epoch_covers_longest_channel(settings, monkeypatch):
    """An epoch is sized by the LONGEST channel (shorter channels wrap
    their sampling) — a data-rich channel must not be undertrained to the
    shortest channel's length (review finding: min(ns) sizing left wrap
    mode dead and starved big channels). Also pins the epoch-program
    contract: ONE device call per epoch with an [S, C, bs] index tensor
    (batches gather on device; no per-step host dispatch, no K-fold
    batch copy)."""
    import dataclasses

    from syllable_detector_tpu.training import trainer as trainer_mod
    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(
        settings, epochs=2, batch_size=8, n_init=1, hidden=(2,)
    )
    rng = np.random.default_rng(0)
    feats = [
        rng.standard_normal((10, s.n_features)).astype(np.float32),
        rng.standard_normal((40, s.n_features)).astype(np.float32),
    ]
    labels = [
        (rng.random(10) > 0.5).astype(np.float32),
        (rng.random(40) > 0.5).astype(np.float32),
    ]

    seen = []
    real_epoch = trainer_mod.make_ensemble_epoch

    def counting(*a, **kw):
        epoch = real_epoch(*a, **kw)

        def wrapped(params, opt_state, feats_all, labs_all, idx):
            idx = np.asarray(idx)
            seen.append(idx.shape)
            # wrap sampling keeps every index within its channel's length
            assert idx[:, 0].max() < 10 and idx[:, 1].max() < 40
            return epoch(params, opt_state, feats_all, labs_all, idx)

        return wrapped

    monkeypatch.setattr(trainer_mod, "make_ensemble_epoch", counting)
    train_ensemble(s, feats, labels)
    # bs = min(8, 10) = 8; epoch covers max(ns)=40 -> 5 steps; quiet mode
    # stacks both epochs into ONE device call: [E*S, C, bs]
    assert seen == [(10, 2, 8)]
    seen.clear()
    train_ensemble(s, feats, labels, verbose=True)  # per-epoch calls
    assert seen == [(5, 2, 8), (5, 2, 8)]


def test_train_cli_parallel_flag_validation(tmp_path):
    """--channel-parallel without multiple pairs (and --data-parallel with
    them) error out instead of being silently ignored (review finding)."""
    from syllable_detector_tpu.train import main as train_main

    rc = train_main(
        ["-a", "a.wav", "-l", "a.csv", "-o", "x.txt", "--channel-parallel"]
    )
    assert rc == 1
    rc = train_main(
        ["-a", "a.wav", "-l", "a.csv", "-a", "b.wav", "-l", "b.csv",
         "-o", "x.txt", "--data-parallel"]
    )
    assert rc == 1


def test_train_cli_single_pair_ch_template(tmp_path):
    """A {ch} output template with ONE -a/-l pair substitutes channel 0
    instead of writing a literal '{ch}' file (review finding)."""
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=2.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    lab = tmp_path / "labels.csv"
    lab.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    out = tmp_path / "net_{ch}.txt"
    rc = train_main(
        ["-a", str(wav), "-l", str(lab), "-o", str(out),
         "--epochs", "3", "--quiet"]
    )
    assert rc == 0
    assert (tmp_path / "net_0.txt").exists()
    assert not (tmp_path / "net_{ch}.txt").exists()


def test_train_step_public_primitive(settings):
    """train_step (the exported single-step API for custom loops) reduces
    the loss on a toy batch and leaves processing params frozen."""
    import jax
    import optax

    from syllable_detector_tpu.training.trainer import (
        _build_net_spec,
        _loss_fn,
        fit_mapminmax,
        init_layer_params,
        train_step,
    )
    from syllable_detector_tpu.ops.processing import specs_to_chain
    from syllable_detector_tpu.config.model_format import ProcessingSpec

    rng = np.random.default_rng(0)
    feats = rng.standard_normal((64, settings.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)
    net_spec = _build_net_spec(settings)
    _, in_params = specs_to_chain(
        [ProcessingSpec("l2normalize"), fit_mapminmax(feats)]
    )
    _, out_params = specs_to_chain(
        [ProcessingSpec("mapminmax", x_offsets=np.zeros(1, np.float32),
                        gains=np.full(1, 2.0, np.float32), y_offset=-1.0)]
    )
    sizes = [settings.n_features, *settings.hidden, 1]
    params = {
        "layers": init_layer_params(jax.random.PRNGKey(0), sizes),
        "process_inputs": in_params,
        "process_outputs": out_params,
    }
    opt_state = optax.adam(1e-3).init(params["layers"])
    loss0 = float(_loss_fn(net_spec, params, feats, labels))
    for _ in range(50):
        params, opt_state, value = train_step(
            net_spec, params, opt_state, feats, labels
        )
    loss1 = float(_loss_fn(net_spec, params, feats, labels))
    assert loss1 < loss0 * 0.9, (loss0, loss1)
    # processing params stay frozen — only the layers train
    import jax as _jax

    for got, want in zip(
        _jax.tree.leaves(params["process_inputs"]),
        _jax.tree.leaves(in_params),
    ):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))



def test_train_quiet_matches_verbose(settings):
    """Quiet mode runs the WHOLE training as one device program; it must
    produce bit-identical results to the per-epoch verbose path (same
    rng, same stacked batch sequence)."""
    import dataclasses
    import io
    from contextlib import redirect_stdout

    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(
        settings, epochs=6, batch_size=16, n_init=2, hidden=(2,)
    )
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((50, s.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)

    _, p_quiet, t_quiet = train(s, feats, labels, verbose=False)
    with redirect_stdout(io.StringIO()):
        _, p_verbose, t_verbose = train(s, feats, labels, verbose=True)
    for a, b in zip(
        __import__("jax").tree.leaves(p_quiet),
        __import__("jax").tree.leaves(p_verbose),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t_quiet == t_verbose

    _, pl_quiet, _ = train_ensemble(s, [feats, feats], [labels, labels])
    with redirect_stdout(io.StringIO()):
        _, pl_verbose, _ = train_ensemble(
            s, [feats, feats], [labels, labels], verbose=True
        )
    for c in range(2):
        for a, b in zip(
            __import__("jax").tree.leaves(pl_quiet[c]),
            __import__("jax").tree.leaves(pl_verbose[c]),
        ):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

def test_train_checkpoint_resume_bit_exact(settings, tmp_path):
    """An interrupted checkpointed run resumes from the latest orbax
    checkpoint and finishes BIT-EXACTLY equal to an uninterrupted run
    (params + adam state roundtrip, epoch rng fast-forward)."""
    import dataclasses

    import jax

    from syllable_detector_tpu.training.trainer import train_ensemble

    rng = np.random.default_rng(2)
    feats = rng.standard_normal((60, settings.n_features)).astype(np.float32)
    labels = (feats[:, 1] > 0).astype(np.float32)

    # --- single net ---
    s6 = dataclasses.replace(settings, epochs=6, batch_size=16,
                             n_init=2, hidden=(2,))
    s4 = dataclasses.replace(s6, epochs=4)
    _, p_full, t_full = train(s6, feats, labels)  # uninterrupted oracle
    d = tmp_path / "ckpt_single"
    _, _, _ = train(s4, feats, labels, checkpoint_dir=str(d),
                    checkpoint_every=2)  # "interrupted" at epoch 4
    _, p_res, t_res = train(s6, feats, labels, checkpoint_dir=str(d),
                            checkpoint_every=2)  # resumes at 4, runs 2
    for a, b in zip(jax.tree.leaves(p_res), jax.tree.leaves(p_full)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t_res == t_full

    # --- ensemble ---
    d2 = tmp_path / "ckpt_ens"
    fl, ll = [feats, feats[:40]], [labels, labels[:40]]
    _, pl_full, _ = train_ensemble(s6, fl, ll)
    train_ensemble(s4, fl, ll, checkpoint_dir=str(d2), checkpoint_every=2)
    _, pl_res, _ = train_ensemble(s6, fl, ll, checkpoint_dir=str(d2),
                                  checkpoint_every=2)
    for c in range(2):
        for a, b in zip(jax.tree.leaves(pl_res[c]), jax.tree.leaves(pl_full[c])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # --- mesh path: checkpoints hold gathered host arrays; resume
    # resharding must reproduce the uninterrupted mesh run ---
    mesh = make_mesh(8, axis="data")
    _, p_mfull, _ = train(s6, feats, labels, mesh=mesh)
    d3 = tmp_path / "ckpt_mesh"
    train(s4, feats, labels, mesh=mesh, checkpoint_dir=str(d3),
          checkpoint_every=2)
    _, p_mres, _ = train(s6, feats, labels, mesh=mesh,
                         checkpoint_dir=str(d3), checkpoint_every=2)
    for a, b in zip(jax.tree.leaves(p_mres), jax.tree.leaves(p_mfull)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_epoch_program_matches_manual_step_loop(settings):
    """Independent oracle for the epoch device program: a K=1 restart
    epoch (lax.scan + on-device gathers) must equal a hand-rolled host
    loop of the public train_step over the same batches (tight float
    tolerance — vmap/scan compile to different fusions than the scalar
    step, so last-ulp drift is expected, drift beyond it is a bug)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import optax

    from syllable_detector_tpu.config.model_format import ProcessingSpec
    from syllable_detector_tpu.models.neural_net import stack_params
    from syllable_detector_tpu.ops.processing import specs_to_chain
    from syllable_detector_tpu.training.trainer import (
        _build_net_spec,
        _make_restart_epoch,
        fit_mapminmax,
        init_layer_params,
        train_step,
    )

    s = dataclasses.replace(settings, hidden=(3,))
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((40, s.n_features)).astype(np.float32)
    labels = (feats[:, 2] > 0).astype(np.float32)
    _, in_params = specs_to_chain(
        [ProcessingSpec("l2normalize"), fit_mapminmax(feats)]
    )
    _, out_params = specs_to_chain(
        [ProcessingSpec("mapminmax", x_offsets=np.zeros(1, np.float32),
                        gains=np.full(1, 2.0, np.float32), y_offset=-1.0)]
    )
    sizes = [s.n_features, *s.hidden, 1]
    base = {
        "layers": init_layer_params(jax.random.PRNGKey(3), sizes),
        "process_inputs": in_params,
        "process_outputs": out_params,
    }
    lr = 2e-3
    idx = rng.integers(0, len(feats), size=(4, 8))  # 4 steps of 8

    # oracle: public single-step API, host loop
    params_o = base
    opt_state_o = optax.adam(lr).init(base["layers"])
    fj = jnp.asarray(feats)
    lj = jnp.asarray(labels)
    for step in range(idx.shape[0]):
        params_o, opt_state_o, _ = train_step(
            _build_net_spec(s), params_o, opt_state_o,
            fj[idx[step]], lj[idx[step]], lr=lr,
        )

    # epoch program: K=1 stacked
    opt = optax.adam(lr)
    stacked = stack_params([base])
    opt_state = jax.vmap(opt.init)(stacked["layers"])
    epoch_fn = _make_restart_epoch(_build_net_spec(s), lr)
    params_e, _, _ = epoch_fn(
        stacked, opt_state, fj, lj, jnp.asarray(idx, jnp.int32)
    )
    for a, b in zip(
        jax.tree.leaves(jax.tree.map(lambda x: x[0], params_e)),
        jax.tree.leaves(params_o),
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
        )


def test_checkpoint_guards(settings, tmp_path):
    """checkpoint_every < 1 and stale-directory reuse fail loudly instead
    of ZeroDivisionError / silently training a chimera of two runs."""
    import dataclasses

    rng = np.random.default_rng(7)
    feats = rng.standard_normal((30, settings.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)
    s = dataclasses.replace(settings, epochs=2, batch_size=8,
                            n_init=1, hidden=(2,))

    with pytest.raises(ValueError, match="checkpoint_every"):
        train(s, feats, labels, checkpoint_dir=str(tmp_path / "x"),
              checkpoint_every=0)

    d = tmp_path / "ckpt"
    train(s, feats, labels, checkpoint_dir=str(d), checkpoint_every=1)
    # different seed => different batch sequence => not a valid resume
    s2 = dataclasses.replace(s, seed=s.seed + 1)
    with pytest.raises(ValueError, match="different training run"):
        train(s2, feats, labels, checkpoint_dir=str(d), checkpoint_every=1)
    # different data likewise
    with pytest.raises(ValueError, match="different training run"):
        train(s, feats * 2.0, labels, checkpoint_dir=str(d),
              checkpoint_every=1)
    # CHANGED LABELS on identical audio (the "fixed the intervals file,
    # same --checkpoint-dir" workflow) must not silently resume: the old
    # sum-only fingerprint ignored labels entirely
    with pytest.raises(ValueError, match="different training run"):
        train(s, feats, 1.0 - labels, checkpoint_dir=str(d),
              checkpoint_every=1)
    # reordered rows keep every total invariant but change the batch
    # sequence — the index-weighted fingerprint must catch them
    perm = np.random.default_rng(0).permutation(len(feats))
    assert not np.array_equal(perm, np.arange(len(feats)))
    with pytest.raises(ValueError, match="different training run"):
        train(s, feats[perm], labels[perm], checkpoint_dir=str(d),
              checkpoint_every=1)
    # ensemble checkpoints don't resume single-net runs
    from syllable_detector_tpu.training.trainer import train_ensemble

    with pytest.raises(ValueError, match="different training run"):
        train_ensemble(s, [feats], [labels], checkpoint_dir=str(d),
                       checkpoint_every=1)
    # shrinking epochs below the checkpoint is an error, not a no-op lie
    s1 = dataclasses.replace(s, epochs=1)
    with pytest.raises(ValueError, match="beyond"):
        train(s1, feats, labels, checkpoint_dir=str(d), checkpoint_every=1)
    # extending epochs in the same dir remains legit (resume + continue)
    s4 = dataclasses.replace(s, epochs=4)
    train(s4, feats, labels, checkpoint_dir=str(d), checkpoint_every=1)


def test_resume_rng_sidecar_and_fallback(settings, tmp_path):
    """Resume restores the epoch rng from the rng_*.json sidecar (O(1) —
    no draw-and-discard of completed epochs); with the sidecar deleted it
    falls back to fast-forward. Both must be BIT-EXACT vs uninterrupted."""
    import dataclasses
    import glob
    import os

    import jax

    rng = np.random.default_rng(11)
    feats = rng.standard_normal((48, settings.n_features)).astype(np.float32)
    labels = (feats[:, 1] > 0).astype(np.float32)
    s6 = dataclasses.replace(settings, epochs=6, batch_size=16,
                             n_init=1, hidden=(2,))
    s4 = dataclasses.replace(s6, epochs=4)
    _, p_full, _ = train(s6, feats, labels)

    d = tmp_path / "ckpt"
    train(s4, feats, labels, checkpoint_dir=str(d), checkpoint_every=2)
    sidecars = sorted(glob.glob(str(d / "rng_*.json")))
    assert sidecars, "rng sidecars were not written alongside checkpoints"

    # the sidecar restores the exact generator state the saving run held
    # after its last completed epoch (O(1) resume, no re-draws)
    from syllable_detector_tpu.training.trainer import _restore_rng_state

    fresh = np.random.default_rng(s6.seed)
    oracle = np.random.default_rng(s6.seed)
    n = len(feats)
    for _ in range(4):  # epochs completed by the interrupted run
        oracle.permutation(n)
    assert _restore_rng_state(str(d), 4, [fresh])
    assert fresh.bit_generator.state == oracle.bit_generator.state

    _, p_res, _ = train(s6, feats, labels, checkpoint_dir=str(d),
                        checkpoint_every=2)
    for a, b in zip(jax.tree.leaves(p_res), jax.tree.leaves(p_full)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # fallback path: delete the sidecars, resume must still be bit-exact
    d2 = tmp_path / "ckpt2"
    train(s4, feats, labels, checkpoint_dir=str(d2), checkpoint_every=2)
    for f in glob.glob(str(d2 / "rng_*.json")):
        os.remove(f)
    _, p_fb, _ = train(s6, feats, labels, checkpoint_dir=str(d2),
                       checkpoint_every=2)
    for a, b in zip(jax.tree.leaves(p_fb), jax.tree.leaves(p_full)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_index_budget_chunking_bit_exact(settings, monkeypatch):
    """Forcing the 64 MiB index budget down to 1 byte makes every quiet
    run chunk one epoch per program — results must stay bit-identical
    (the budget only bounds memory, never changes the batch sequence)."""
    import dataclasses

    import jax

    from syllable_detector_tpu.training import trainer as trainer_mod
    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(
        settings, epochs=5, batch_size=16, n_init=2, hidden=(2,)
    )
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((40, s.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)

    _, p_one, t_one = train(s, feats, labels)  # whole run, one program
    _, pl_one, _ = train_ensemble(s, [feats], [labels])
    monkeypatch.setattr(trainer_mod, "_INDEX_BUDGET_BYTES", 1)
    _, p_chunked, t_chunked = train(s, feats, labels)  # epoch per program
    _, pl_chunked, _ = train_ensemble(s, [feats], [labels])
    for a, b in zip(jax.tree.leaves(p_one), jax.tree.leaves(p_chunked)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t_one == t_chunked
    for a, b in zip(jax.tree.leaves(pl_one[0]), jax.tree.leaves(pl_chunked[0])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_resume_fuzz_bit_exact(settings, tmp_path, seed):
    """Randomized interrupt points and checkpoint cadences (multiple
    sequential resumes through the rng-sidecar path, final extension to
    the full run) stay BIT-EXACT vs the uninterrupted oracle."""
    import dataclasses

    import jax

    r = np.random.default_rng(100 + seed)
    feats = r.standard_normal((50, settings.n_features)).astype(np.float32)
    labels = (feats[:, 0] > 0).astype(np.float32)
    total = int(r.integers(5, 10))
    ce = int(r.integers(1, 4))
    s_full = dataclasses.replace(settings, epochs=total, batch_size=16,
                                 n_init=1, hidden=(2,))
    _, p_full, _ = train(s_full, feats, labels)
    d = tmp_path / f"ck{seed}"
    points = sorted(set(int(x) for x in r.integers(1, total, size=2)))
    for ep in points + [total]:
        s_i = dataclasses.replace(s_full, epochs=ep)
        _, p_res, _ = train(s_i, feats, labels, checkpoint_dir=str(d),
                            checkpoint_every=ce)
    for a, b in zip(jax.tree.leaves(p_res), jax.tree.leaves(p_full)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_corrupt_fingerprint_file_gives_clear_error(settings, tmp_path):
    """A truncated fingerprint.json (crash mid-write on an old version)
    surfaces as a ValueError naming the directory, not a JSONDecodeError."""
    from syllable_detector_tpu.training.trainer import _check_fingerprint

    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "fingerprint.json").write_text('{"epochs": 5, "tr')
    with pytest.raises(ValueError, match="unreadable fingerprint"):
        _check_fingerprint(str(d), {"epochs": 5})


def test_corrupt_rng_sidecar_falls_back(settings, tmp_path):
    """A corrupt rng_*.json sidecar must not abort resume: _restore_rng_state
    returns False and the caller's draw-and-discard fast-forward (bit-exact,
    just slower) takes over."""
    import numpy as np

    from syllable_detector_tpu.training.trainer import _restore_rng_state

    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "rng_00000004.json").write_text("[{broken")
    rng = np.random.default_rng(7)
    before = rng.bit_generator.state
    assert not _restore_rng_state(str(d), 4, [rng])
    assert rng.bit_generator.state == before  # untouched on failure


def test_fit_mapstd(dataset):
    """MATLAB mapstd fit: transformed features have mean 0, sample std 1
    (convert_to_text.m:157-167 emits xOffsets/gains/yMean for mapstd)."""
    from syllable_detector_tpu.training.trainer import fit_mapstd

    _, _, feats, _ = dataset
    ms = fit_mapstd(feats)
    y = (feats - ms.x_offsets) * ms.gains + ms.y_offset
    np.testing.assert_allclose(y.mean(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(y.std(axis=0, ddof=1), 1.0, atol=1e-3)
    # zero-variance features keep gain 1 (like fit_mapminmax's zero-range)
    const = np.ones((8, 3), np.float32)
    ms2 = fit_mapstd(const)
    np.testing.assert_allclose(ms2.gains, 1.0)


def test_input_processing_validation():
    with pytest.raises(ValueError, match="unknown input processing"):
        TrainSettings(input_processing=("l2normalize", "mapcube"))
    with pytest.raises(ValueError, match="must precede"):
        TrainSettings(input_processing=("mapstd", "l2normalize"))
    # fitted-affine sequences and free prefixes are fine
    TrainSettings(input_processing=("normalizestd", "mapminmax", "mapstd"))


def test_fit_input_chain_sequential(dataset):
    """Each fitted affine sees the previous stages' output (MATLAB
    configures processFcns sequentially)."""
    from syllable_detector_tpu.training.trainer import fit_input_chain

    _, _, feats, _ = dataset
    s = TrainSettings(input_processing=("l2normalize", "mapstd"))
    specs, transformed = fit_input_chain(s, feats)
    assert [sp.name for sp in specs] == ["l2normalize", "mapstd"]
    # the mapstd was fit on the l2-normalized features: output is standard
    np.testing.assert_allclose(transformed.mean(axis=0), 0.0, atol=1e-3)
    np.testing.assert_allclose(transformed.std(axis=0, ddof=1), 1.0, atol=2e-3)


def test_train_mapstd_roundtrip(settings, dataset):
    """Train with the mapstd chain -> export -> text roundtrip -> detect:
    the exporter's mapstd settings block (convert_to_text.m:157-167) comes
    back through the parser and the net still separates syllables."""
    import dataclasses

    audio, intervals, feats, labels = dataset
    s = dataclasses.replace(
        settings, input_processing=("l2normalize", "mapstd")
    )
    net_spec, params, threshold = train(s, feats, labels)
    assert net_spec.input_processing == ("l2normalize", "mapstd")

    cfg = export_trained_config(s, net_spec, params, threshold)
    text = dumps_config(cfg)
    assert "mapstd" in text and "yMean" in text  # the reference schema block
    cfg2 = loads_config(text)
    assert [p.name for p in cfg2.process_inputs] == ["l2normalize", "mapstd"]

    det = Detector(cfg2)
    det.append_audio_data(audio)
    outs = det.drain()
    hop = settings.window_length - settings.window_overlap
    first = settings.window_length + hop * (settings.time_range - 1)
    t = (first + hop * np.arange(len(outs))) / settings.sampling_rate
    inside = np.zeros(len(outs), bool)
    near = np.zeros(len(outs), bool)
    for lo, hi in intervals:
        inside |= (t >= lo) & (t <= hi)
        near |= (t >= lo - 0.1) & (t <= hi + 0.1)
    assert outs[inside, 0].mean() > outs[~near, 0].mean() + 0.3


def test_train_mapstd_only_chain_fused_parity(settings, dataset):
    """A mapstd-only chain (no l2normalize) exports, reloads, and the
    affine constant folding (fold_input_affines has_l2=False, used by the
    tensor-parallel path) matches the unfolded path on it."""
    import dataclasses

    from syllable_detector_tpu.models.detector import (
        detector_spec_from_config,
        fusable,
        offline_outputs,
    )
    from syllable_detector_tpu.parallel.mesh import (
        make_mesh,
        tensor_sharded_offline_outputs,
    )

    audio, intervals, feats, labels = dataset
    s = dataclasses.replace(
        settings, epochs=20, input_processing=("mapstd",)
    )
    net_spec, params, threshold = train(s, feats, labels)
    cfg2 = loads_config(
        dumps_config(export_trained_config(s, net_spec, params, threshold))
    )
    spec, p2 = detector_spec_from_config(cfg2)
    assert fusable(spec)
    base = np.asarray(offline_outputs(spec, p2, audio))
    fused = np.asarray(
        tensor_sharded_offline_outputs(make_mesh(4, axis="model"), spec, p2, audio)
    )
    assert len(base) > 0 and fused.shape == base.shape
    np.testing.assert_allclose(fused, base, atol=2e-3)


def test_train_cli_mapstd(tmp_path):
    """--input-processing l2normalize,mapstd end-to-end: train, write the
    net file, detect with the CLI."""
    import io
    from contextlib import redirect_stdout

    from syllable_detector_tpu.cli import main as cli_main
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=3.0)
    wav = tmp_path / "train.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "labels.csv"
    labels.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    net = tmp_path / "net.txt"
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(net),
         "--epochs", "150", "--quiet",
         "--input-processing", "l2normalize,mapstd"]
    )
    assert rc == 0 and net.exists()
    assert "mapstd" in net.read_text()

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli_main(["-n", str(net), "-a", str(wav)])
    assert rc == 0
    lines = [l for l in buf.getvalue().splitlines() if l]
    assert lines
    hits = sum(
        1 for line in lines
        if any(lo - 0.1 <= float(line.split(",")[2]) <= hi + 0.1
               for lo, hi in intervals)
    )
    assert hits / len(lines) > 0.8, (hits, len(lines))


def test_train_cli_bad_input_processing(tmp_path):
    from syllable_detector_tpu.train import main as train_main
    from syllable_detector_tpu.utils.wav import write_wav

    audio, intervals = make_labeled_audio(seconds=1.0)
    wav = tmp_path / "a.wav"
    write_wav(wav, audio, 44100, dtype="float32")
    labels = tmp_path / "l.csv"
    labels.write_text("\n".join(f"{lo},{hi}" for lo, hi in intervals))
    rc = train_main(
        ["-a", str(wav), "-l", str(labels), "-o", str(tmp_path / "n.txt"),
         "--epochs", "1", "--quiet", "--input-processing", "mapcube"]
    )
    assert rc == 1


def test_train_ensemble_mapstd_chain(settings):
    """Ensembles fit the selected chain PER CHANNEL (each channel's
    mapstd sees its own l2-normalized features) and export it."""
    import dataclasses

    from syllable_detector_tpu.models.neural_net import apply_net
    from syllable_detector_tpu.training.trainer import train_ensemble

    s = dataclasses.replace(
        settings, epochs=100, input_processing=("l2normalize", "mapstd")
    )
    feats, labels, _, _ = _two_channel_dataset(s)
    net_spec, params_list, thresholds = train_ensemble(s, feats, labels)
    assert net_spec.input_processing == ("l2normalize", "mapstd")
    # per-channel fits differ (the channels' feature statistics differ)
    o0 = np.asarray(params_list[0]["process_inputs"][1]["x_offsets"])
    o1 = np.asarray(params_list[1]["process_inputs"][1]["x_offsets"])
    assert np.abs(o0 - o1).max() > 1e-6
    for c in range(2):
        preds = np.asarray(
            apply_net(net_spec, params_list[c], feats[c])[..., 0]
        )
        sep = preds[labels[c] > 0.5].mean() - preds[labels[c] < 0.5].mean()
        assert sep > 0.3, (c, sep)
        cfg = export_trained_config(s, net_spec, params_list[c],
                                    thresholds[c])
        assert "mapstd" in dumps_config(cfg)
