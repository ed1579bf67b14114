"""Port vs reference: the decode-network cache (cache.py).

Both packages key a network by the same digest and save it in the same
.npz layout, so each loads the other's file to equal arrays, for a
monophone network and for a triphone network with pseudo phone sets;
`Engine(use_cache=True)` builds its network once and reads it back from
the cache directory after that.
"""

import os

import numpy as np
import pytest

from julius_tpu import cache as jcache
from julius_tpu.io.htk_dict import (Vocabulary as JVocabulary,
                                    parse_dict_line as jdict_line)
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.search.network import build_network as jbuild
from julius_tpu_torch import cache as tcache
from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.engine import Engine
from julius_tpu_torch.io.htk_dict import (Vocabulary as TVocabulary,
                                          parse_dict_line as tdict_line)
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text as tparse_hmm
from julius_tpu_torch.search.network import build_network as tbuild

from fixtures import make_dict_text, make_hmmdefs_text
from test_iwcd2 import PHONES as TRI_PHONES
from test_torch_pass1_unfused import TRI_DICT
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

MODELS = {"mono": (("a", "b", "c", "sil"), make_dict_text().splitlines()),
          "triphone": (TRI_PHONES, TRI_DICT)}
NET_FIELDS = ("score_idx", "in_src", "in_lp", "entry_word", "entry_lp",
              "exit_word", "exit_lp", "word_node_ofs")
PSEUDO_FIELDS = ("set_ns", "set_state_ofs", "set_trans_phone", "members",
                 "member_ofs")


def models(name, pkg):
    phones, lines = MODELS[name]
    parse_hmm, Voc, dict_line = (
        (tparse_hmm, TVocabulary, tdict_line) if pkg == "torch"
        else (jparse_hmm, JVocabulary, jdict_line))
    voca = Voc()
    for line in lines:
        dict_line(line, voca)
    return parse_hmm(make_hmmdefs_text(phones=phones, dim=4, n_states=3,
                                       n_mix=1)), voca


def assert_same_nets(a, b):
    for f in NET_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("n_score_rows", "head_word", "tail_word"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.pseudo is None) == (b.pseudo is None)
    if a.pseudo is not None:
        assert a.pseudo.name_index == b.pseudo.name_index
        for f in PSEUDO_FIELDS:
            np.testing.assert_array_equal(getattr(a.pseudo, f),
                                          getattr(b.pseudo, f))


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("saver", ["torch", "jax"])
def test_each_package_loads_the_others_network(name, saver, tmp_path):
    thmm, tvoca = models(name, "torch")
    jhmm, jvoca = models(name, "jax")
    assert tcache.network_digest(thmm, tvoca, iwsp=False) == \
        jcache.network_digest(jhmm, jvoca, iwsp=False)
    tnet, jnet = tbuild(thmm, tvoca), jbuild(jhmm, jvoca)
    assert (tnet.pseudo is not None) == (name == "triphone")
    path = str(tmp_path / "net.npz")
    if saver == "torch":
        tcache.save_network(tnet, path)
        got, want = jcache.load_network(path), jnet
    else:
        jcache.save_network(jnet, path)
        got, want = tcache.load_network(path), tnet
    assert_same_nets(got, want)


def test_engine_use_cache_builds_once(tmp_path, monkeypatch):
    monkeypatch.setenv("JULIUS_TPU_CACHE", str(tmp_path / "cache"))
    hmm, voca = models("mono", "torch")
    first = Engine(hmm, voca, use_cache=True, search=SearchConfig(),
                   device="cpu")
    files = os.listdir(tmp_path / "cache")
    assert len(files) == 1
    again = Engine(hmm, voca, use_cache=True, device="cpu")
    assert os.listdir(tmp_path / "cache") == files
    assert_same_nets(again.net, first.net)
    assert_same_nets(again.net, tbuild(hmm, voca))
