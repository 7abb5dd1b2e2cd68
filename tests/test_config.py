"""Config/model-format parser tests against the checked-in sample net."""

import numpy as np
import pytest

from syllable_detector_tpu.config.model_format import (
    ConfigError,
    dumps_config,
    loads_config,
)

from conftest import SAMPLE_TXT as SAMPLE


def test_sample_scalars(sample_config):
    cfg = sample_config
    assert cfg.sampling_rate == 44100.0
    assert cfg.fourier_length == 256
    assert cfg.window_length == 256
    assert cfg.window_overlap == 124
    assert cfg.freq_range == (2000.0, 7000.0)
    assert cfg.time_range == 10
    assert cfg.scaling == "linear"
    assert cfg.thresholds == [0.9240389823913577]
    # legacy singular `threshold` key fallback (the reference's own
    # example net writes `threshold =`)
    legacy = loads_config(
        open(SAMPLE).read().replace("thresholds = ", "threshold = ")
    )
    assert legacy.thresholds == cfg.thresholds


def test_sample_layers(sample_config):
    cfg = sample_config
    assert len(cfg.layers) == 2
    l0, l1 = cfg.layers
    assert (l0.inputs, l0.outputs, l0.transfer) == (290, 4, "TanSig")
    assert (l1.inputs, l1.outputs, l1.transfer) == (4, 1, "PureLin")
    assert l0.weights.shape == (4, 290)
    assert l1.weights.shape == (1, 4)
    # row-major outputs x inputs: first row starts with the first values
    assert l0.weights[0, 0] == np.float32(-1.0348469018936157)
    assert l0.weights[0, 1] == np.float32(-0.2567209005355835)
    assert l1.biases[0] == np.float32(-1.29518723487854)
    assert cfg.net_inputs == 290
    assert cfg.net_outputs == 1


def test_sample_processing(sample_config):
    cfg = sample_config
    assert [p.name for p in cfg.process_inputs] == ["l2normalize", "mapminmax"]
    assert [p.name for p in cfg.process_outputs] == ["mapminmax"]
    mm = cfg.process_inputs[1]
    assert mm.x_offsets.shape == (290,)
    assert mm.gains.shape == (290,)
    assert mm.y_offset == -1.0
    out = cfg.process_outputs[0]
    assert out.gains[0] == 2.0 and out.x_offsets[0] == 0.0 and out.y_offset == -1.0


def test_derived_quantities(sample_config):
    cfg = sample_config
    assert cfg.hop == 132  # 256 - 124
    assert cfg.gap == 0 and cfg.overlap == 124
    # window + hop*(timeRange-1) = 256 + 132*9 = 1444
    assert cfg.first_output_sample == 1444


def test_gap_semantics():
    text = (
        "samplingRate = 1000\nfourierLength = 8\nwindowLength = 8\n"
        "windowOverlap = -4\nfreqRange = 0, 500\ntimeRange = 2\n"
        "thresholds = 0.5\nscaling = linear\nprocessInputsCount = 0\n"
        "processOutputsCount = 0\nlayers = 1\nlayer0.inputs = 8\n"
        "layer0.outputs = 1\n"
        "layer0.weights = 1,1,1,1,1,1,1,1\nlayer0.biases = 0\n"
        "layer0.transferFunction = PureLin\n"
    )
    cfg = loads_config(text)
    assert cfg.gap == 4 and cfg.overlap == 0 and cfg.hop == 12
    # first output: window + (window-overlap)*(T-1) - overlap = 8 + 12 + 4 = 24
    assert cfg.first_output_sample == 24


def test_window_length_defaults_to_fft():
    text = open(SAMPLE).read().replace("windowLength = 256\n", "")
    cfg = loads_config(text)
    assert cfg.window_length == 256


def test_comment_and_garbage_lines_ignored(sample_config):
    text = "# a comment line\njunk without equals\na = b = c\n" + open(SAMPLE).read()
    cfg = loads_config(text)
    assert cfg.fourier_length == sample_config.fourier_length


def test_errors():
    base = open(SAMPLE).read()
    with pytest.raises(ConfigError) as e:
        loads_config(base.replace("fourierLength = 256", "fourierLength = 257"))
    assert e.value.kind == "invalidValue"
    with pytest.raises(ConfigError) as e:
        loads_config(base.replace("samplingRate = 44100", ""))
    assert e.value.kind == "missingValue"
    with pytest.raises(ConfigError) as e:
        loads_config(base.replace("layer1.biases = -1.29518723487854",
                                  "layer1.biases = -0.7, 0.2"))
    assert e.value.kind == "mismatchedLength"
    with pytest.raises(ConfigError):
        loads_config(base.replace("scaling = linear", "scaling = weird"))
    with pytest.raises(ConfigError):
        loads_config(base.replace("layer0.transferFunction = TanSig",
                                  "layer0.transferFunction = ReLU"))


def test_roundtrip(sample_config):
    text = dumps_config(sample_config)
    cfg2 = loads_config(text)
    assert cfg2.thresholds == sample_config.thresholds
    assert cfg2.window_overlap == sample_config.window_overlap
    for a, b in zip(cfg2.layers, sample_config.layers):
        np.testing.assert_array_equal(a.weights, b.weights)
        np.testing.assert_array_equal(a.biases, b.biases)
        assert a.transfer == b.transfer
    for a, b in zip(cfg2.process_inputs, sample_config.process_inputs):
        assert a.name == b.name
        np.testing.assert_array_equal(a.x_offsets, b.x_offsets)
        np.testing.assert_array_equal(a.gains, b.gains)
        assert a.y_offset == b.y_offset
