"""Port vs reference: the server and its clients (server/module.py,
server/adinnet.py, server/vecnet.py, tools/serve.py, tools/jcontrol.py,
tools/adintool.py).

The same inputs (numpy, from seeds) go through both packages, on the
CPU:

* the same module command script, every command of the protocol with
  the grammar commands, gives the same messages from both packages'
  ModuleServer, except VERSION's engine name and configuration (the one
  deliberate difference), and leaves the same grammars and processes;
* result_to_xml gives the same block for the same Result;
* adinnet and vecnet are byte-compatible both ways: both packages'
  clients send the same bytes, each package's server reads the other's
  client, and the servers send the same control bytes;
* serve() end to end, each package on a small flagship engine (the
  port's on the reference's tables): the same noise segments over
  adinnet give the same <RECOGOUT> words, scores within atol 1e-3;
* both packages' grammar rebuild drops a DNN engine's scorer (the
  reference's defect, kept for parity) and keeps the engine's device;
* jcontrol prints the same lines; adintool writes the same WAV bytes,
  sends the same samples over adinnet and features within 1e-4 over
  vecnet;
* serve.main and adintool.main need CUDA unless the CPU is asked for.
"""

import contextlib
import importlib
import io
import queue
import re
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch

from julius_tpu.config import SearchConfig as JSearchConfig
from julius_tpu.engine import Engine as JEngine
from julius_tpu.engine import Result as JResult
from julius_tpu.io.arpa import parse_arpa as jparse_arpa
from julius_tpu.io.dfa import parse_dfa as jparse_dfa
from julius_tpu.io.dnn import DNNParams as JDNNParams
from julius_tpu.io.htk_dict import Vocabulary as JVocabulary
from julius_tpu.io.htk_dict import parse_dict_line as jparse_dict
from julius_tpu.io.htk_hmm import parse_hmmdefs_text as jparse_hmm
from julius_tpu.server import adinnet as jadin
from julius_tpu.server import module as jmodule
from julius_tpu.server import vecnet as jvec
from julius_tpu.tools import adintool as jadintool
from julius_tpu.tools import jcontrol as jjcontrol
from julius_tpu.tools import serve as jserve
from julius_tpu.tools.synth import flagship_engine
from julius_tpu_torch.config import SearchConfig
from julius_tpu_torch.engine import Engine, Result
from julius_tpu_torch.io.arpa import parse_arpa
from julius_tpu_torch.io.dfa import parse_dfa
from julius_tpu_torch.io.dnn import DNNParams
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.io.htk_hmm import parse_hmmdefs_text
from julius_tpu_torch.io.wav import write_wav
from julius_tpu_torch.server import adinnet as tadin
from julius_tpu_torch.server import module as tmodule
from julius_tpu_torch.server import vecnet as tvec
from julius_tpu_torch.tools import adintool as tadintool
from julius_tpu_torch.tools import jcontrol as tjcontrol
from julius_tpu_torch.tools import serve as tserve

from fixtures import make_arpa_text, make_dfa_text, make_dict_text, \
    make_hmmdefs_text
from test_torch_pass2_device import converted_engine
import torch_fixtures  # noqa: F401  (one intra-op thread a worker)

# the logging modules (each package's utils/__init__ exports the
# function under the module's name)
jjlog = importlib.import_module("julius_tpu.utils.jlog")
tjlog = importlib.import_module("julius_tpu_torch.utils.jlog")
TIMEOUT = 60
PORT_ENGINE = dict(Engine=Engine, Vocabulary=Vocabulary,
                   parse_dict=parse_dict_line, parse_hmm=parse_hmmdefs_text,
                   parse_lm=parse_arpa, parse_dfa=parse_dfa,
                   Search=SearchConfig, DNN=DNNParams, kw=dict(device="cpu"))
REF_ENGINE = dict(Engine=JEngine, Vocabulary=JVocabulary,
                  parse_dict=jparse_dict, parse_hmm=jparse_hmm,
                  parse_lm=jparse_arpa, parse_dfa=jparse_dfa,
                  Search=JSearchConfig, DNN=JDNNParams, kw={})
VERSION_MSG = {
    "torch": '<ENGINEINFO TYPE="julius_tpu_torch" VERSION="r1" '
             'CONF="cuda"/>',
    "jax": '<ENGINEINFO TYPE="julius_tpu" VERSION="r1" CONF="tpu"/>'}


def ngram_engine(p):
    """The reference test_server.py's N-gram engine, in package `p`."""
    hmm = p["parse_hmm"](make_hmmdefs_text(
        phones=("a", "b", "sil"), dim=26, n_states=3, n_mix=2))
    voca = p["Vocabulary"]()
    for line in make_dict_text([("<s>", "[]", ["sil"]),
                                ("</s>", "[]", ["sil"]),
                                ("AB", "[ab]", ["a", "b"]),
                                ("BA", "[ba]", ["b", "a"])]).splitlines():
        p["parse_dict"](line, voca)
    lm = p["parse_lm"](io.StringIO(make_arpa_text()))
    return p["Engine"](hmm, voca, lm, search=p["Search"](lm_weight=2.0),
                       **p["kw"])


def grammar_engine(p, dnn=False):
    """The reference test_server.py's grammar engine, in package `p`;
    with `dnn`, a one-layer DNN scorer over its 4-dim features."""
    hmm = p["parse_hmm"](make_hmmdefs_text(
        phones=("a", "b", "sil"), dim=4, n_states=3, n_mix=2))
    dfa = p["parse_dfa"](io.StringIO(make_dfa_text()))
    voca = p["Vocabulary"]()
    for line in ["0\t[ab]\ta b", "1\t[ba]\tb a"]:
        p["parse_dict"](line, voca)
    kw = dict(p["kw"])
    if dnn:
        rng = np.random.default_rng(0)
        S = hmm.n_states
        kw["dnn"] = p["DNN"](
            weights=[rng.standard_normal((4, 8)).astype(np.float32)],
            biases=[np.zeros(8, np.float32)],
            output_w=rng.standard_normal((8, S)).astype(np.float32),
            output_b=np.zeros(S, np.float32),
            log_prior=np.full(S, np.log10(1.0 / S), np.float32),
            context_len=1, feature_len=4)
    return p["Engine"](hmm, voca, dfa=dfa,
                       word_cat=np.asarray([0, 1], dtype=np.int32),
                       search=p["Search"](), **kw)


def read_msg(f):
    """Read one module message (lines until a single '.')."""
    lines = []
    while True:
        line = f.readline()
        if not line:
            return None
        if line.strip() == b".":
            return b"\n".join(lines).decode()
        lines.append(line.rstrip(b"\n"))


def run_script(Server, engines, script):
    """Send each (text, replies) of `script` to a ModuleServer over
    `engines` -> (the replies of each step, the server's grammars and
    processes after each step)."""
    srv = Server(engines, port=0)
    t = threading.Thread(target=lambda: (srv.accept(), srv.serve_forever()),
                         daemon=True)
    t.start()
    sock = socket.create_connection(("127.0.0.1", srv.port))
    f = sock.makefile("rb")
    msgs, states = [], []
    try:
        for text, n in script:
            sock.sendall(text.encode())
            msgs.append([read_msg(f) for _ in range(n)])
            states.append(dict(
                words=[list(e.voca.names) for e in srv.engines],
                cats=[None if e.word_cat is None else list(e.word_cat)
                      for e in srv.engines],
                lmtypes=[e.lmtype for e in srv.engines],
                active=list(srv.process_active), current=srv.current,
                flags=(srv.active, srv.terminated),
                grammars={gid: (g["name"], g["active"], g["voca"].n_words,
                                g["dfa"].n_states)
                          for gid, g in srv.grammars.items()}))
        sock.sendall(b"DIE\n")
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
    finally:
        f.close()
        sock.close()
        srv._srv.close()
    return msgs, states, srv


def assert_same_messages(got, want):
    """Equal messages, VERSION's aside, which names each package."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w == [VERSION_MSG["jax"]]:
            assert g == [VERSION_MSG["torch"]]
        else:
            assert g == w


GRAMMAR_BODY = make_dfa_text() + "0\t[aa]\ta a\n1\t[bb]\tb b\nDICEND\n"
SCRIPTS = {
    "control": [
        ("STATUS\n", 1), ("VERSION\n", 1), ("PAUSE\n", 1), ("STATUS\n", 1),
        ("TERMINATE\n", 1), ("STATUS\n", 1), ("RESUME\n", 1),
        ("INPUTONCHANGE\nPAUSE\n", 0), ("NOSUCHCOMMAND\n", 0),
        ("STATUS\n", 1), ("GRAMINFO\n", 1), ("SYNCGRAM\n", 1),
        ("LISTPROCESS\n", 1), ("CURRENTPROCESS\n", 1),
        ("ADDPROCESS {jconf}\n", 1), ("LISTPROCESS\n", 1),
        ("CURRENTPROCESS 1\n", 1), ("DEACTIVATEPROCESS\n", 1),
        ("LISTPROCESS\n", 1), ("ACTIVATEPROCESS _default\n", 1),
        ("ADDPROCESS {missing}\n", 1), ("DELPROCESS nosuch\n", 1),
        ("DELPROCESS _default\n", 1), ("LISTPROCESS\n", 1),
        ("CURRENTPROCESS\n", 1)],
    "grammar": [
        ("GRAMINFO\n", 1), ("ADDGRAM g2\n" + GRAMMAR_BODY, 1),
        ("GRAMINFO\n", 1), ("DEACTIVATEGRAM 1\n", 1), ("GRAMINFO\n", 1),
        ("ACTIVATEGRAM 1\n", 1),
        ("ADDWORD 0\n0\t[abab]\ta b a b\nDICEND\n", 1),
        ("ADDWORD 7\n0\t[ba]\tb a\nDICEND\n", 1),
        ("DEACTIVATEGRAM\n", 1), ("GRAMINFO\n", 1), ("ACTIVATEGRAM\n", 1),
        ("SYNCGRAM\n", 1), ("DELGRAM 1\n", 1), ("GRAMINFO\n", 1),
        ("CHANGEGRAM g3\n" + make_dfa_text()
         + "0\t[ba]\tb a\n1\t[ab]\ta b\n1\t[bab]\tb a b\nDICEND\n", 1),
        ("GRAMINFO\n", 1), ("CHANGEGRAM bad\nnot a dfa\nDFAEND\nDICEND\n", 1),
        ("LISTPROCESS\n", 1), ("CURRENTPROCESS\n", 1)],
}


@pytest.fixture(scope="module")
def jconf(tmp_path_factory):
    """A jconf on model files for ADDPROCESS (the N-gram engine's)."""
    d = tmp_path_factory.mktemp("addprocess")
    (d / "hmmdefs").write_text(make_hmmdefs_text(
        phones=("a", "b", "sil"), dim=26, n_states=3, n_mix=2))
    (d / "words.dict").write_text(make_dict_text([
        ("<s>", "[]", ["sil"]), ("</s>", "[]", ["sil"]),
        ("AB", "[ab]", ["a", "b"]), ("BA", "[ba]", ["b", "a"])]))
    (d / "lm.arpa").write_text(make_arpa_text())
    (d / "run.jconf").write_text(
        f"-h {d}/hmmdefs\n-v {d}/words.dict\n-d {d}/lm.arpa\n")
    return d


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_module_messages_match_reference(case, jconf):
    make = ngram_engine if case == "control" else grammar_engine
    script = [(text.format(jconf=jconf / "run.jconf",
                           missing=jconf / "missing.jconf"), n)
              for text, n in SCRIPTS[case]]
    got, got_states, _ = run_script(tmodule.ModuleServer,
                                    [make(PORT_ENGINE)], script)
    want, want_states, _ = run_script(jmodule.ModuleServer,
                                      [make(REF_ENGINE)], script)
    assert_same_messages(got, want)
    assert got_states == want_states
    if case == "grammar":
        assert 'STATUS="ERROR"' in got[7][0] and 'REASON="7"' in got[7][0]
        assert got_states[5]["words"] == [["0", "1", "2", "3"]]
        assert len(got_states[-1]["words"][0]) == 3
    else:
        assert any("ADDED" in m[0] for m in got if m)
        assert got_states[-1]["words"] == []


def test_result_xml_matches_reference():
    cases = [
        dict(words=["<s>", "AB", "</s>"], texts=["", "ab", ""],
             word_ids=[0, 2, 1], score=-12.5, cm=[1.0, 0.9, 1.0]),
        dict(words=["<s>", "BA", "</s>"], texts=[], word_ids=[0, 3, 1],
             score=-7.123456789),
        dict(valid=False, reject_reason="too short"),
    ]
    for kw in cases:
        got = tmodule.result_to_xml(Result(**kw))
        want = jmodule.result_to_xml(JResult(**kw))
        assert got == want
    nb = [dict(words=["<s>", w, "</s>"], texts=["", w.lower(), ""],
               word_ids=[0, i, 1], score=-3.0 - i, cm=[1.0, 0.5, 1.0])
          for i, w in ((2, "AB"), (3, "BA"))]
    got = tmodule.result_to_xml(Result(**nb[0], nbest=[
        Result(**k) for k in nb]))
    want = jmodule.result_to_xml(JResult(**nb[0], nbest=[
        JResult(**k) for k in nb]))
    assert got == want and 'RANK="2"' in got


# ---------------------------------------------------------------------------
# the wire formats
# ---------------------------------------------------------------------------

def raw_bytes(send):
    """Bytes a client sends: `send(port)` runs the client against a raw
    listening socket, which reads until the client closes."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    t = threading.Thread(target=send, args=(srv.getsockname()[1],),
                         daemon=True)
    t.start()
    conn, _ = srv.accept()
    chunks = []
    while True:
        c = conn.recv(65536)
        if not c:
            break
        chunks.append(c)
    t.join(timeout=TIMEOUT)
    conn.close()
    srv.close()
    return b"".join(chunks)


def adinnet_audio():
    rng = np.random.default_rng(11)
    a = rng.standard_normal(9000) * 12000          # clipped at int16
    return [a.astype(np.float32), np.arange(-300, 300, dtype=np.float32),
            np.full(4096, 7.0, np.float32)]


def adinnet_send(mod):
    def send(port):
        c = mod.AdinnetClient(port=port)
        for k, a in enumerate(adinnet_audio()):
            c.send_samples(a)
            if k != 1:
                c.send_segment_end()
        c.close()
    return send


def vecnet_frames():
    rng = np.random.default_rng(12)
    return [rng.standard_normal((17, 26)).astype(np.float32),
            rng.standard_normal((5, 26)).astype(np.float32)]


def vecnet_send(mod, outprob):
    def send(port):
        c = mod.VecnetClient(veclen=26, port=port, fshift_ms=10,
                             outprob=outprob)
        for fr in vecnet_frames():
            c.send_frames(fr)
            c.send_segment_end()
        c.send_stream_end()
        c.close()
    return send


def test_clients_send_the_reference_bytes():
    got = raw_bytes(adinnet_send(tadin))
    assert got == raw_bytes(adinnet_send(jadin))
    assert len(got) == 2 * (9000 + 600 + 4096) + 4 * 7   # 5 chunks, 2 ends
    for outprob in (False, True):
        got = raw_bytes(vecnet_send(tvec, outprob))
        assert got == raw_bytes(vecnet_send(jvec, outprob))
        assert got[:16] == bytes([12, 0, 0, 0, 26, 0, 0, 0, 10, 0, 0, 0,
                                  int(outprob), 0, 0, 0])


def read_events(server_mod, kind, send):
    """A `kind` ("adinnet" / "vecnet") server of `server_mod` reading the
    client `send` -> (its events, its configuration)."""
    cls = server_mod.AdinnetServer if kind == "adinnet" \
        else server_mod.VecnetServer
    srv = cls(port=0)
    t = threading.Thread(target=send, args=(srv.port,), daemon=True)
    t.start()
    srv.accept()
    events = [(k, None if v is None else v.copy()) for k, v in srv.events()]
    conf = None if kind == "adinnet" else (srv.veclen, srv.fshift_ms,
                                           srv.is_outprob)
    t.join(timeout=TIMEOUT)
    srv.close()
    return events, conf


WIRE = {"adinnet": adinnet_send, "vecnet": lambda m: vecnet_send(m, True)}
PAIRS = {"port_server_reference_client": ((tadin, tvec), (jadin, jvec)),
         "reference_server_port_client": ((jadin, jvec), (tadin, tvec))}


@pytest.mark.parametrize("kind", sorted(WIRE))
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_servers_read_the_other_package_clients(kind, pair):
    (srv_a, srv_v), (cli_a, cli_v) = PAIRS[pair]
    srv_mod = srv_a if kind == "adinnet" else srv_v
    cli_mod = cli_a if kind == "adinnet" else cli_v
    got, conf = read_events(srv_mod, kind, WIRE[kind](cli_mod))
    want, want_conf = read_events(jadin if kind == "adinnet" else jvec,
                                  kind, WIRE[kind](jadin if kind == "adinnet"
                                                   else jvec))
    assert conf == want_conf
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w)
    if kind == "vecnet":
        assert conf == (26, 10, True)
        rows = np.stack([v for k, v in got if k == "vector"])
        assert np.array_equal(rows, np.concatenate(vecnet_frames()))
    else:
        samples = [v for k, v in got if k == "samples"]
        assert np.array_equal(np.concatenate(samples)[-4096:],
                              np.full(4096, 7))


def test_adinnet_control_bytes_match_reference():
    def control(mod):
        srv = mod.AdinnetServer(port=0)
        cli = socket.create_connection(("127.0.0.1", srv.port))
        srv.accept()
        srv.send_pause()
        srv.send_terminate()
        srv.send_resume()
        srv.close()
        data = b""
        while len(data) < 3:
            c = cli.recv(16)
            if not c:
                break
            data += c
        cli.close()
        return data
    assert control(tadin) == control(jadin) == b"012"


# ---------------------------------------------------------------------------
# serving end to end
# ---------------------------------------------------------------------------

class PortWatch(io.TextIOBase):
    """A log stream that picks serve()'s "module port X, adinnet port Y"
    line out of the log."""

    def __init__(self):
        self.ports = queue.Queue()

    def write(self, s):
        m = re.search(r"module port (\d+), adinnet port (\d+)", s)
        if m:
            self.ports.put((int(m.group(1)), int(m.group(2))))
        return len(s)


def serve_segments(serve, jlog, engines, client_mod, waves, **kw):
    """serve(engines) on a thread with system-chosen ports; a module
    client connects, `client_mod`'s AdinnetClient sends each waveform
    and a segment end -> (the module messages, the module server)."""
    watch, box = PortWatch(), {}
    jlog.set_log_output(watch)
    t = threading.Thread(target=lambda: box.update(mod=serve(
        engines, module_port=0, adin_port=0, **kw)), daemon=True)
    try:
        t.start()
        mport, aport = watch.ports.get(timeout=TIMEOUT)
    finally:
        jlog.set_log_output(jlog.DEFAULT)
    ctl = socket.create_connection(("127.0.0.1", mport))
    f = ctl.makefile("rb")
    cli = client_mod.AdinnetClient(port=aport)
    msgs = []
    for w in waves:
        cli.send_samples(w)
        cli.send_segment_end()
        msgs.append(read_msg(f))
    cli.close()
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    ctl.sendall(b"DIE\n")
    f.close()
    ctl.close()
    box["mod"]._srv.close()
    return msgs, box["mod"]


NUMBER = re.compile(r"-?\d+\.\d+")


def assert_same_xml(got, want, atol=1e-3):
    """Equal blocks once the scores are masked; scores within atol."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
    np.testing.assert_allclose([float(x) for x in NUMBER.findall(got)],
                               [float(x) for x in NUMBER.findall(want)],
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def flagship():
    """The small flagship DNN engine of the reference and the port's
    engine on its tables."""
    eng, _ = flagship_engine(trained=True, n_words=120, n_phones=48,
                             hidden=128, n_layers=2)
    return converted_engine(eng), eng


def test_serve_end_to_end_matches_reference(flagship):
    teng, jeng = flagship
    rng = np.random.default_rng(0)
    waves = [(rng.standard_normal(n) * 3000).astype(np.float32)
             for n in (12000, 9000)]
    got, _ = serve_segments(tserve.serve, tjlog, [teng], tadin, waves)
    want, _ = serve_segments(jserve.serve, jjlog, [jeng], jadin, waves)
    for g, w in zip(got, want):
        assert "<RECOGOUT>" in w and 'WORD="' in w
        assert_same_xml(g, w)
    # the port's own batch decode of the same samples
    for g, w in zip(got, waves):
        r = teng.recognize_batch(w[None], np.asarray([len(w)]))[0]
        assert re.findall(r'CLASSID="([^"]*)"', g.split("</SHYPO>")[0]) \
            == r.words


def test_grammar_rebuild_drops_the_dnn_in_both_packages():
    """The reference's rebuild passes no DNN: a DNN grammar engine comes
    back scored by the HMM set's GMM after CHANGEGRAM.  The port copies
    it (ROADMAP.md queue 3, reference defects); the new engine stays on
    the old one's device."""
    script = [("CHANGEGRAM g\n" + GRAMMAR_BODY, 1)]
    engines = {}
    for name, p, Server in (("torch", PORT_ENGINE, tmodule.ModuleServer),
                            ("jax", REF_ENGINE, jmodule.ModuleServer)):
        eng = grammar_engine(p, dnn=True)
        assert eng.dnn_scorer is not None
        msgs, _, srv = run_script(Server, [eng], script)
        assert msgs == [['<GRAMMAR STATUS="RECEIVED" ID="1"/>']]
        assert srv.engines[0] is not eng
        engines[name] = srv.engines[0]
    for new in engines.values():
        assert new.dnn_scorer is None and new.gmm_tables is not None
        assert new.voca.names == ["0", "1"]
    assert engines["torch"].device == torch.device("cpu")


# ---------------------------------------------------------------------------
# jcontrol and adintool
# ---------------------------------------------------------------------------

class PacedStdin:
    """Standard input for jcontrol: each command goes out once the
    replies of the ones before it have been printed."""

    def __init__(self, script, out):
        self.script, self.out = script, out

    def __iter__(self):
        want = 0
        for text, n in self.script:
            yield text
            want += n
            deadline = time.monotonic() + TIMEOUT
            while self.out.getvalue().splitlines().count(".") < want:
                assert time.monotonic() < deadline, self.out.getvalue()
                time.sleep(0.005)


def jcontrol_lines(jcontrol, Server, engines, script):
    srv = Server(engines, port=0)
    t = threading.Thread(target=lambda: (srv.accept(), srv.serve_forever()),
                         daemon=True)
    t.start()
    out = io.StringIO()
    real = sys.stdin
    sys.stdin = PacedStdin(script, out)
    try:
        with contextlib.redirect_stdout(out):
            assert jcontrol.main(["127.0.0.1", str(srv.port)]) == 0
    finally:
        sys.stdin = real
    # jcontrol's reader thread keeps its socket open; ending the
    # connection here ends both the reader and the command loop
    srv._client.shutdown(socket.SHUT_RDWR)
    t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    srv._client.close()
    srv._srv.close()
    return out.getvalue().splitlines()


def test_jcontrol_prints_like_reference():
    script = [("STATUS\n", 1), ("VERSION\n", 1), ("\n", 0), ("PAUSE\n", 1),
              ("GRAMINFO\n", 1), ("ADDGRAM g2\n", 0),
              ("".join(ln + "\n" for ln in GRAMMAR_BODY.splitlines()), 1),
              ("GRAMINFO\n", 1), ("LISTPROCESS\n", 1), ("RESUME\n", 1)]
    got = jcontrol_lines(tjcontrol, tmodule.ModuleServer,
                         [grammar_engine(PORT_ENGINE)], script)
    want = jcontrol_lines(jjcontrol, jmodule.ModuleServer,
                          [grammar_engine(REF_ENGINE)], script)
    assert [ln for ln in got if "ENGINEINFO" not in ln] == \
        [ln for ln in want if "ENGINEINFO" not in ln]
    assert VERSION_MSG["torch"] in got and got.count(".") == 8
    assert '  #1: [active] 2 words, 3 states "g2"' in got


@pytest.fixture(scope="module")
def bursts(tmp_path_factory):
    """A 16 kHz WAV of three noise bursts between near-silence."""
    d = tmp_path_factory.mktemp("adintool")
    rng = np.random.default_rng(31)
    parts = [30.0 * rng.standard_normal(8000)]
    for n in (16000, 12000, 14000):
        parts += [3000.0 * rng.standard_normal(n),
                  30.0 * rng.standard_normal(12000)]
    wave = np.concatenate(parts).astype(np.float32)
    write_wav(str(d / "bursts.wav"), wave, 16000)
    return d, wave


class Collector:
    """An adinnet or vecnet server of the port on a thread, reading one
    client: `.events` once the client has closed."""

    def __init__(self, kind):
        self.srv = (tadin.AdinnetServer if kind == "adinnet"
                    else tvec.VecnetServer)(port=0)
        self.events = None
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        self.srv.accept()
        self.events = [(k, v) for k, v in self.srv.events()]

    def close(self):
        self.t.join(timeout=TIMEOUT)
        assert not self.t.is_alive()
        self.srv.close()
        return self.events


def run_adintool(main, argv, stdin=b"", **kw):
    """adintool's main with `stdin` as its standard input -> (its text
    output, its binary output)."""
    out = io.TextIOWrapper(io.BytesIO(), write_through=True)
    real_in, real_out = sys.stdin, sys.stdout
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    sys.stdout = out
    try:
        assert main(argv, **kw) == 0
    finally:
        sys.stdin, sys.stdout = real_in, real_out
    raw = out.buffer.getvalue()
    return raw.decode("latin-1"), raw


ADINTOOL = {
    "file": ["-out", "file", "-filename-out", "{out}/seg"],
    "file_oneshot": ["-out", "file", "-filename-out", "{out}/seg",
                     "-oneshot", "-lv", "1500"],
    "adinnet": ["-out", "adinnet", "-server", "127.0.0.1:{port}"],
    "vecnet": ["-out", "vecnet", "-server", "127.0.0.1:{port}"],
    "stdin_stdout": ["-in", "stdin", "-out", "stdout", "-nosegment"],
}


@pytest.mark.parametrize("case", sorted(ADINTOOL))
def test_adintool_matches_reference(bursts, case):
    d, wave = bursts
    stdin = np.clip(wave, -32768, 32767).astype("<i2").tobytes()
    outputs = {}
    for pkg, main, kw in (("torch", tadintool.main, dict(device="cpu")),
                          ("jax", jadintool.main, {})):
        out = d / f"{case}_{pkg}"
        out.mkdir()
        kind = case if case in ("adinnet", "vecnet") else None
        col = Collector(kind) if kind else None
        argv = ["-in", "file", "-filename", str(d / "bursts.wav")] + [
            a.format(out=out, port=col.srv.port if col else 0)
            for a in ADINTOOL[case]]
        text, raw = run_adintool(main, argv, stdin=stdin, **kw)
        outputs[pkg] = dict(
            text=text.replace(str(out), "OUT"), raw=raw,
            files={p.name: p.read_bytes() for p in sorted(out.iterdir())},
            events=col.close() if col else None)
    got, want = outputs["torch"], outputs["jax"]
    assert got["text"] == want["text"]
    assert got["files"] == want["files"]
    if case.startswith("file"):
        assert len(got["files"]) == (1 if case == "file_oneshot" else 3)
    elif case == "stdin_stdout":
        assert got["raw"] == want["raw"] == stdin
    else:
        g, w = got["events"], want["events"]
        assert [k for k, _ in g] == [k for k, _ in w]
        assert [k for k, _ in g].count("segment") == 3
        for (_, a), (_, b) in zip(g, w):
            if b is None:
                continue
            if case == "adinnet":
                assert np.array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("which", ["serve", "adintool"])
def test_entry_points_need_cuda_unless_cpu_is_asked(which, jconf, bursts,
                                                    monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _ = bursts
    if which == "serve":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["-C", str(jconf / "run.jconf")])
        return
    argv = ["-in", "file", "-filename", str(d / "bursts.wav"),
            "-out", "file", "-filename-out", str(d / "cuda_check")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tadintool.main(argv)
    text, _ = run_adintool(tadintool.main, argv, device="cpu")
    assert text.count("wrote ") == 3
