"""The port's LM data pipeline (``repro_torch.data.pipeline``, numpy
only) against the JAX package's: every array of ``make_batch`` bit-equal
(dtype, shape and values) for a decoder-only model, an encoder-decoder
model (``frames``) and a vision model (``image_embeds``), over steps,
hosts and data configs; ``batches`` yields the same stream from any
start step."""
import itertools

import numpy as np
import pytest

from repro import configs as JC
from repro.data import pipeline as JP
from repro_torch import configs as TC
from repro_torch.data import pipeline as TP

ARCHS = ("llama3.2-1b", "whisper-tiny", "llama-3.2-vision-90b")


def _cfgs(arch):
    return JC.get_config(arch).reduced(), TC.get_config(arch).reduced()


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (7, 0, 1),
                                               (3, 1, 2), (11, 3, 4)])
def test_make_batch_bit_equal(arch, step, host, n_hosts):
    jcfg, tcfg = _cfgs(arch)
    shape = (JC.ShapeConfig("t", "train", 32, 8),
             TC.ShapeConfig("t", "train", 32, 8))
    want = JP.make_batch(jcfg, shape[0], step, host=host, n_hosts=n_hosts)
    got = TP.make_batch(tcfg, shape[1], step, host=host, n_hosts=n_hosts)
    _equal(got, want)
    assert got["tokens"].shape == (8 // n_hosts, 32)
    assert ("frames" in got) == tcfg.is_encdec
    assert ("image_embeds" in got) == bool(tcfg.n_img_tokens)


@pytest.mark.parametrize("seed,zipf_a,mix", [(1234, 1.3, 0.7), (5, 2.0, 0.0),
                                             (99, 1.1, 1.0)])
def test_data_config_bit_equal(seed, zipf_a, mix):
    jcfg, tcfg = _cfgs("llama3.2-1b")
    got = TP.make_batch(tcfg, TC.ShapeConfig("t", "train", 64, 4), 2,
                        TP.DataConfig(seed, zipf_a, mix))
    want = JP.make_batch(jcfg, JC.ShapeConfig("t", "train", 64, 4), 2,
                         JP.DataConfig(seed, zipf_a, mix))
    _equal(got, want)


@pytest.mark.parametrize("start", [0, 5])
def test_batches_stream_from_start_step(start):
    jcfg, tcfg = _cfgs("whisper-tiny")
    tshape = TC.ShapeConfig("t", "train", 16, 2)
    got = list(itertools.islice(TP.batches(tcfg, tshape, start), 3))
    want = list(itertools.islice(
        JP.batches(jcfg, JC.ShapeConfig("t", "train", 16, 2), start), 3))
    for g, w in zip(got, want):
        _equal(g, w)
    _equal(got[1], TP.make_batch(tcfg, tshape, start + 1))
