"""adinnet audio transfer protocol (server + client).

Port of `julius_tpu/server/adinnet.py` (host code, a copy).
Reference: `libsent/src/adin/adin_tcpip.c` (server side, default port
5530) and `adintool` as the canonical client.  Wire format
(libsent/src/net/rdwt.c): each message is a native-byte-order int32
byte length followed by that many bytes of 16-bit little-endian PCM;
a zero length marks end-of-segment.  Server-to-client control bytes:
'0' = pause, '1' = terminate, '2' = resume (adin_tcpip_send_*).
"""

from __future__ import annotations

import socket
import struct
from typing import Iterator, Optional

import numpy as np

ADINNET_PORT = 5530


def _read_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class AdinnetServer:
    """Accepts one adinnet client and yields audio events.

    Iterate `events()`: ("samples", float32 array) | ("segment", None)
    on end-of-segment | ("eos", None) on disconnect."""

    def __init__(self, port: int = ADINNET_PORT, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self._client: Optional[socket.socket] = None

    def accept(self):
        self._client, _ = self._srv.accept()

    def events(self) -> Iterator[tuple]:
        assert self._client is not None, "call accept() first"
        while True:
            hdr = _read_exact(self._client, 4)
            if hdr is None:
                yield ("eos", None)
                return
            (length,) = struct.unpack("=i", hdr)
            if length < 0:
                yield ("eos", None)
                return
            if length == 0:
                yield ("segment", None)
                continue
            data = _read_exact(self._client, length)
            if data is None:
                yield ("eos", None)
                return
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32)
            yield ("samples", samples)

    def send_pause(self):
        self._client.sendall(b"0")

    def send_terminate(self):
        self._client.sendall(b"1")

    def send_resume(self):
        self._client.sendall(b"2")

    def close(self):
        if self._client:
            self._client.close()
        self._srv.close()


class AdinnetClient:
    """Sends audio to an adinnet server (the adintool role,
    adintool/adintool.c)."""

    def __init__(self, host: str = "127.0.0.1", port: int = ADINNET_PORT):
        self._sock = socket.create_connection((host, port))

    def send_samples(self, samples: np.ndarray, chunk: int = 4096):
        s = np.clip(np.asarray(samples), -32768, 32767).astype("<i2")
        raw = s.tobytes()
        for ofs in range(0, len(raw), chunk * 2):
            seg = raw[ofs: ofs + chunk * 2]
            self._sock.sendall(struct.pack("=i", len(seg)) + seg)

    def send_segment_end(self):
        self._sock.sendall(struct.pack("=i", 0))

    def close(self):
        self._sock.close()
