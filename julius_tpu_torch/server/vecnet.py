"""vecnet: feature / outprob vector input over TCP.

Port of `julius_tpu/server/vecnet.py` (host code, a copy).
Reference: `libsent/src/anlz/vecin_net.c` (server, port 5531) and
`dnntools/sendvec.c` (client).  Framing: every message is int32 length
+ body; length 0 = end of segment, negative = end of stream.  The first
message is a 12-byte configuration header {int32 veclen, int32
fshift_ms, uint8 outprob_p + 3 pad} (ConfigurationHeader, padded to 4).
Each subsequent message carries one float32 vector of veclen.
"""

from __future__ import annotations

import socket
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

VECNET_PORT = 5531
_CONF = struct.Struct("<iiBxxx")


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        if not c:
            return None
        buf += c
    return buf


class VecnetServer:
    """Accepts one vector-input client (reference vecin_open/read)."""

    def __init__(self, port: int = VECNET_PORT, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._client: Optional[socket.socket] = None
        self.veclen = 0
        self.fshift_ms = 10
        self.is_outprob = False

    def accept(self):
        self._client, _ = self._srv.accept()
        hdr = self._read_msg()
        if hdr is None or len(hdr) != _CONF.size:
            raise IOError("vecnet: bad configuration header")
        self.veclen, self.fshift_ms, outp = _CONF.unpack(hdr)
        self.is_outprob = bool(outp)

    def _read_msg(self) -> Optional[bytes]:
        raw = _read_exact(self._client, 4)
        if raw is None:
            return None
        (length,) = struct.unpack("<i", raw)
        if length == 0:
            return b""          # end of segment
        if length < 0:
            return None         # end of stream
        return _read_exact(self._client, length)

    def events(self) -> Iterator[Tuple[str, Optional[np.ndarray]]]:
        """("vector", [veclen] f32) | ("segment", None) | ("eos", None)."""
        while True:
            msg = self._read_msg()
            if msg is None:
                yield ("eos", None)
                return
            if msg == b"":
                yield ("segment", None)
                continue
            yield ("vector", np.frombuffer(msg, dtype="<f4").copy())

    def close(self):
        if self._client:
            self._client.close()
        self._srv.close()


class VecnetClient:
    """Sends vectors to a vecnet server (the dnntools/sendvec.c role)."""

    def __init__(self, veclen: int, host: str = "127.0.0.1",
                 port: int = VECNET_PORT, fshift_ms: int = 10,
                 outprob: bool = False):
        self._sock = socket.create_connection((host, port))
        hdr = _CONF.pack(veclen, fshift_ms, 1 if outprob else 0)
        self._sock.sendall(struct.pack("<i", len(hdr)) + hdr)
        self.veclen = veclen

    def send_vector(self, vec: np.ndarray):
        body = np.ascontiguousarray(vec, dtype="<f4").tobytes()
        self._sock.sendall(struct.pack("<i", len(body)) + body)

    def send_frames(self, frames: np.ndarray):
        for row in np.asarray(frames):
            self.send_vector(row)

    def send_segment_end(self):
        self._sock.sendall(struct.pack("<i", 0))

    def send_stream_end(self):
        self._sock.sendall(struct.pack("<i", -1))

    def close(self):
        self._sock.close()
