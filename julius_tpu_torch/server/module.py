"""Module-mode server: the TCP control/result protocol.

Port of `julius_tpu/server/module.py`.  Reference: `julius/module.c`
(commands, default port 10500) and `julius/output_module.c` (XML-ish
result messages).  Wire format: newline-terminated command strings in;
out-messages are XML fragments terminated by a line containing a single
'.' (module_send "...\\n.\\n").

Commands covered (reference module.c:214-683): STATUS, VERSION, DIE,
PAUSE, TERMINATE, RESUME, INPUTONCHANGE, GRAMINFO, CHANGEGRAM, ADDGRAM,
DELGRAM, ACTIVATEGRAM, DEACTIVATEGRAM, SYNCGRAM, ADDWORD, ADDPROCESS,
DELPROCESS, ACTIVATEPROCESS, DEACTIVATEPROCESS, LISTPROCESS,
CURRENTPROCESS.  Grammar payloads arrive like the reference's: dfa+dict
body over the socket after the command line; grammar state is kept per
gid with an active flag and the merged global grammar is rebuilt on
every change (reference multigram_update at the next stream loop).

Every message is the reference package's, except VERSION's engine name
and configuration (`julius_tpu_torch`, `cuda`).  A grammar rebuild makes
a new Engine on the old engine's device, from the thread that runs the
command loop; like the reference's, it passes the old engine's HMM set,
front end, search and AM configurations and nothing else (no DNN, no
-gshmm selector, no inter-word short pause, no rejection settings).
"""

from __future__ import annotations

import contextlib
import io
import socket
from typing import Dict, List, Optional

import numpy as np
import torch

from julius_tpu_torch.engine import Engine, Result
from julius_tpu_torch.fusion import create_engines, merge_grammars
from julius_tpu_torch.io.dfa import parse_dfa
from julius_tpu_torch.io.htk_dict import Vocabulary, parse_dict_line
from julius_tpu_torch.jconf import parse_jconf
from julius_tpu_torch.utils.jlog import LogLevel, jlog

MODULE_PORT = 10500
VERSION_STR = "julius_tpu_torch"


def result_to_xml(r: Result, voca=None) -> str:
    """<RECOGOUT> block (reference output_module.c result_pass2)."""
    if not r.valid:
        return '<RECOGFAIL/>\n'
    out = ['<RECOGOUT>']
    nbest = r.nbest or [r]
    for rank, h in enumerate(nbest, 1):
        out.append(f'  <SHYPO RANK="{rank}" SCORE="{h.score:.6f}">')
        cms = h.cm if h.cm is not None else [None] * len(h.words)
        for w, t, cm in zip(h.words, h.texts or h.words, cms):
            attrs = f'WORD="{t}" CLASSID="{w}"'
            if cm is not None:
                attrs += f' CM="{cm:.3f}"'
            out.append(f'    <WHYPO {attrs}/>')
        out.append('  </SHYPO>')
    out.append('</RECOGOUT>\n')
    return "\n".join(out)


def _parse_grammar(dfa_text: str, dict_text: str):
    """Parse an in-band grammar body into (dfa, voca, word_cat)."""
    dfa = parse_dfa(io.StringIO(dfa_text))
    voca = Vocabulary()
    for line in dict_text.splitlines():
        if line.strip() and line.strip() not in ("DFAEND", "DICEND"):
            parse_dict_line(line, voca)
    word_cat = np.asarray([int(n) for n in voca.names], dtype=np.int32)
    return dfa, voca, word_cat


def _on_card_of(engine):
    """A context that makes the engine's card this thread's current CUDA
    device: the current device is kept per thread, and an engine on
    "cuda" (no index) places its tensors on the current one."""
    dev = engine.dev_net.score_idx.device
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


class ModuleServer:
    """One-client control server driving a recognition engine; engines
    that ADDPROCESS loads go to the first engine's device."""

    def __init__(self, engines: List, port: int = MODULE_PORT,
                 host: str = "127.0.0.1"):
        self.engines = engines
        self.device = engines[0].device if engines else "cuda"
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._client: Optional[socket.socket] = None
        self._rfile = None
        self.active = True
        self.terminated = False
        self.alive = True
        # gid -> {name, dfa, voca, word_cat, active}
        self.grammars: Dict[int, dict] = {}
        self._next_gid = 0
        self.current = 0                      # CURRENTPROCESS index
        self.process_active = [True] * len(engines)
        for e in engines:
            if e.lmtype == "grammar" and e.dfa is not None:
                self.grammars[self._next_gid] = dict(
                    name="startup", dfa=e.dfa, voca=e.voca,
                    word_cat=e.word_cat, active=True)
                self._next_gid += 1
                break

    # -- plumbing ---------------------------------------------------------

    def accept(self):
        self._client, _ = self._srv.accept()
        self._rfile = self._client.makefile("rb")

    def send(self, msg: str):
        if self._client is not None:
            self._client.sendall(msg.encode("utf-8") + b".\n")

    def send_result(self, r: Result):
        self.send(result_to_xml(r))

    def _readline(self) -> Optional[str]:
        line = self._rfile.readline()
        if not line:
            return None
        return line.decode("utf-8", errors="replace").strip()

    # -- command loop -----------------------------------------------------

    def serve_forever(self):
        """Blocking command loop (reference msock_check_and_process)."""
        while self.alive:
            cmd = self._readline()
            if cmd is None:
                break
            if cmd:
                self.execute(cmd)

    def execute(self, cmd: str):
        """One command (reference msock_exec_command, module.c:198)."""
        if cmd == "STATUS":
            st = "ACTIVE" if self.active else "SLEEP"
            self.send(f'<SYSINFO PROCESS="{st}"/>\n')
        elif cmd == "VERSION":
            self.send(f'<ENGINEINFO TYPE="{VERSION_STR}" VERSION="r1" '
                      'CONF="cuda"/>\n')
        elif cmd == "DIE":
            self.alive = False
            if self._client:
                self._client.close()
                self._client = None
        elif cmd == "PAUSE" or cmd == "TERMINATE":
            self.active = False
            self.terminated = cmd == "TERMINATE"
            self.send('<SYSINFO PROCESS="SLEEP"/>\n')
        elif cmd == "RESUME":
            self.active = True
            self.terminated = False
            self.send('<SYSINFO PROCESS="ACTIVE"/>\n')
        elif cmd == "INPUTONCHANGE":
            self._readline()   # TERMINATE|PAUSE|WAIT argument
        elif cmd == "GRAMINFO":
            lines = ["<GRAMINFO>"]
            for gid, g in self.grammars.items():
                st = "active" if g["active"] else "inactive"
                lines.append(f'  #{gid}: [{st}] {g["voca"].n_words} words, '
                             f'{g["dfa"].n_states} states "{g["name"]}"')
            lines.append("</GRAMINFO>\n")
            self.send("\n".join(lines))
        elif cmd.startswith(("CHANGEGRAM", "ADDGRAM")):
            name = cmd.split(None, 1)[1] if " " in cmd else "grammar"
            dfa_text, dict_text = self._read_grammar_body()
            try:
                dfa, voca, word_cat = _parse_grammar(dfa_text, dict_text)
                gid = self._next_gid
                self._next_gid += 1
                if cmd.startswith("CHANGEGRAM"):
                    self.grammars = {}
                self.grammars[gid] = dict(name=name, dfa=dfa, voca=voca,
                                          word_cat=word_cat, active=True)
                self._rebuild_grammar()
                self.send(f'<GRAMMAR STATUS="RECEIVED" ID="{gid}"/>\n')
            except Exception as e:
                self.send(f'<GRAMMAR STATUS="ERROR" REASON="{e}"/>\n')
        elif cmd.startswith("DELGRAM"):
            for g in cmd.split()[1:]:
                self.grammars.pop(int(g), None)
            self._rebuild_grammar()
            self.send('<GRAMMAR STATUS="READY"/>\n')
        elif cmd.startswith(("ACTIVATEGRAM", "DEACTIVATEGRAM")):
            on = cmd.startswith("ACTIVATEGRAM")
            ids = [int(g) for g in cmd.split()[1:]] or list(self.grammars)
            for gid in ids:
                if gid in self.grammars:
                    self.grammars[gid]["active"] = on
            self._rebuild_grammar()
            self.send('<GRAMMAR STATUS="READY"/>\n')
        elif cmd.startswith("SYNCGRAM"):
            self._rebuild_grammar()
            self.send('<GRAMMAR STATUS="READY"/>\n')
        elif cmd.startswith("ADDWORD"):
            # ADDWORD gid; dict entries until DICEND (reference
            # msock_exec_command ADDWORD -> multigram add words)
            parts = cmd.split()
            gid = int(parts[1]) if len(parts) > 1 else 0
            dict_lines = []
            while True:
                line = self._readline()
                if line is None or line.strip() == "DICEND":
                    break
                dict_lines.append(line)
            try:
                g = self.grammars[gid]
                n0 = g["voca"].n_words
                for line in dict_lines:
                    if line.strip():
                        parse_dict_line(line, g["voca"])
                g["word_cat"] = np.asarray(
                    [int(n) for n in g["voca"].names], dtype=np.int32)
                self._rebuild_grammar()
                self.send(f'<GRAMMAR STATUS="WORDADDED" '
                          f'NUM="{g["voca"].n_words - n0}"/>\n')
            except Exception as e:
                self.send(f'<GRAMMAR STATUS="ERROR" REASON="{e}"/>\n')
        elif cmd.startswith("ADDPROCESS"):
            # ADDPROCESS jconffile: the argument is a jconf path on the
            # server host (reference module.c ADDPROCESS -> j_process_*_new
            # + j_launch_recognition_instance)
            path = cmd.split(None, 1)[1].strip()
            try:
                new = create_engines(parse_jconf(["-C", path]),
                                     device=self.device)
                self.engines.extend(new)
                self.process_active.extend([True] * len(new))
                self.send(f'<PROCESS STATUS="ADDED" NUM="{len(new)}"/>\n')
            except Exception as e:
                self.send(f'<PROCESS STATUS="ERROR" REASON="{e}"/>\n')
        elif cmd.startswith("DELPROCESS"):
            name = cmd.split(None, 1)[1].strip()
            keep = [(e, a) for e, a in zip(self.engines, self.process_active)
                    if e.search_cfg.name != name]
            self.engines[:] = [e for e, _ in keep]
            self.process_active = [a for _, a in keep]
            self.current = min(self.current, max(0, len(self.engines) - 1))
            self.send('<PROCESS STATUS="DELETED"/>\n')
        elif cmd.startswith(("ACTIVATEPROCESS", "DEACTIVATEPROCESS")):
            on = cmd.startswith("ACTIVATEPROCESS")
            name = cmd.split(None, 1)[1].strip() if " " in cmd else None
            for i, e in enumerate(self.engines):
                if name is None or e.search_cfg.name == name:
                    self.process_active[i] = on
            self.send('<PROCESS STATUS="OK"/>\n')
        elif cmd == "LISTPROCESS":
            lines = ["<PROCESSLIST>"]
            for i, e in enumerate(self.engines):
                st = "ACTIVE" if self.process_active[i] else "INACTIVE"
                lines.append(
                    f'  <PROCESS ID="{i}" NAME="{e.search_cfg.name}" '
                    f'LMTYPE="{e.lmtype}" STATUS="{st}"/>')
            lines.append("</PROCESSLIST>\n")
            self.send("\n".join(lines))
        elif cmd.startswith("CURRENTPROCESS"):
            arg = cmd.split(None, 1)[1].strip() if " " in cmd else None
            if arg:
                for i, e in enumerate(self.engines):
                    if e.search_cfg.name == arg or str(i) == arg:
                        self.current = i
                        break
            self.send(f'<PROCESS ID="{self.current}"/>\n')
        else:
            jlog(LogLevel.WARNING, f"module: unknown command {cmd!r}")

    # -- grammar updates --------------------------------------------------

    def _read_grammar_body(self):
        """Grammar body: dfa lines until 'DFAEND', dict lines until
        'DICEND' (reference read from the same socket)."""
        dfa_lines, dict_lines = [], []
        while True:
            line = self._readline()
            if line is None:
                raise IOError("connection closed mid-grammar")
            dfa_lines.append(line)
            if line.strip() == "DFAEND":
                break
        while True:
            line = self._readline()
            if line is None:
                raise IOError("connection closed mid-grammar")
            dict_lines.append(line)
            if line.strip() == "DICEND":
                break
        return "\n".join(dfa_lines), "\n".join(dict_lines)

    def _rebuild_grammar(self):
        """Merge all active grammars and swap grammar-mode engines
        (reference multigram_update multi-gram.c:627 -> rebuild wchmm;
        we rebuild the flat decode network, which is fast).  The new
        engine lands on the old one's card; the decode loop takes it up
        between segments."""
        active = [(g["dfa"], g["voca"], g["word_cat"])
                  for g in self.grammars.values() if g["active"]]
        if not active:
            return
        dfa, voca, word_cat = active[0] if len(active) == 1 \
            else merge_grammars(active)
        for i, e in enumerate(self.engines):
            if e.lmtype == "grammar":
                with _on_card_of(e):
                    self.engines[i] = Engine(
                        e.hmm, voca, dfa=dfa, word_cat=word_cat,
                        frontend=e.fe_cfg, search=e.search_cfg,
                        am_cfg=e.am_cfg, device=e.device)
