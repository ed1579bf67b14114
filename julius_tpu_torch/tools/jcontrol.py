"""Module-mode control client — the jcontrol equivalent.

Port of `julius_tpu/tools/jcontrol.py` (host code, a copy).
Reference: `jcontrol/jcontrol.c:275` (sample client sending commands,
printing responses).

    python -m julius_tpu_torch.tools.jcontrol [host [port]]  # interactive
    echo "STATUS" | python -m julius_tpu_torch.tools.jcontrol host
"""

from __future__ import annotations

import socket
import sys
import threading


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    host = argv[0] if argv else "127.0.0.1"
    port = int(argv[1]) if len(argv) > 1 else 10500
    sock = socket.create_connection((host, port))
    f = sock.makefile("rb")
    done = threading.Event()

    def reader():
        while not done.is_set():
            line = f.readline()
            if not line:
                done.set()
                break
            sys.stdout.write(line.decode("utf-8", errors="replace"))
            sys.stdout.flush()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        for line in sys.stdin:
            cmd = line.strip()
            if not cmd:
                continue
            sock.sendall((cmd + "\n").encode())
            if cmd == "DIE":
                break
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    done.set()
    sock.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
