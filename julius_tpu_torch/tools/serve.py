"""Server-mode recognizer: adinnet audio in, module protocol out.

Port of `julius_tpu/tools/serve.py`.  Reference composition: `julius
-module -input adinnet` (module.c server + adin_tcpip.c audio input),
with adintool as the audio feeder and jcontrol as the control client.

    python -m julius_tpu_torch.tools.serve -C run.jconf \\
        [-module [port]] [-adport port]

The engines decode on the card (`main(argv, device="cpu")` runs on the
CPU).  The module command loop runs on a thread of its own; a grammar
change there builds a new engine on the same card, which the decode
loop takes up between segments, as the reference does.
"""

from __future__ import annotations

import sys
import threading

from julius_tpu_torch.frontend.stream import vad_config_from
from julius_tpu_torch.fusion import create_engines
from julius_tpu_torch.jconf import parse_jconf
from julius_tpu_torch.server.adinnet import ADINNET_PORT, AdinnetServer
from julius_tpu_torch.server.module import MODULE_PORT, ModuleServer
from julius_tpu_torch.streaming import StreamSession
from julius_tpu_torch.utils.jlog import LogLevel, jlog


def serve(engines, module_port=MODULE_PORT, adin_port=ADINNET_PORT,
          host="127.0.0.1", use_vad=False, max_segments=None, ecfg=None):
    """Run until the module client sends DIE (or max_segments decoded).
    Both ports are logged once the sockets listen (a port given as 0 is
    chosen by the system)."""
    vad_cfg = None
    if ecfg is not None:
        vad_cfg = vad_config_from(ecfg, engines[0].fe_cfg.sample_rate)
    mod = ModuleServer(engines, port=module_port, host=host)
    adin = AdinnetServer(port=adin_port, host=host)
    jlog(LogLevel.STAT,
         f"module port {mod.port}, adinnet port {adin.port}")

    def run_module():
        mod.accept()
        mod.serve_forever()

    threading.Thread(target=run_module, daemon=True).start()

    adin.accept()

    def cur_engine():
        return mod.engines[min(mod.current, len(mod.engines) - 1)]

    session = StreamSession(cur_engine(), vad=vad_cfg, use_vad=use_vad)
    n_seg = 0
    for kind, payload in adin.events():
        if not mod.alive:
            break
        # live process/grammar switching (CURRENTPROCESS / CHANGEGRAM
        # replace the engine object; pick it up at the next event)
        if session.engine is not cur_engine() and not session._in_segment:
            session = StreamSession(cur_engine(), vad=vad_cfg, use_vad=use_vad)
        if kind == "samples":
            if mod.active and mod.process_active[
                    min(mod.current, len(mod.process_active) - 1)]:
                for r in session.feed(payload):
                    mod.send_result(r)
                    n_seg += 1
        elif kind == "segment":
            for r in session.close():
                mod.send_result(r)
                n_seg += 1
            session = StreamSession(cur_engine(), vad=vad_cfg, use_vad=use_vad)
        elif kind == "eos":
            for r in session.close():
                mod.send_result(r)
                n_seg += 1
            break
        if max_segments is not None and n_seg >= max_segments:
            break
    adin.close()
    return mod


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    cfg = parse_jconf(argv)
    engines = create_engines(cfg, device=device)
    serve(engines,
          module_port=cfg.module_port or MODULE_PORT,
          adin_port=cfg.adinnet_port or ADINNET_PORT,
          use_vad=cfg.use_vad, ecfg=cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
