"""Binary N-gram (bingram v5) reader/writer.

Reference format: `libsent/src/ngram/ngram_write_bin.c` (writer) and
`ngram_read_bin.c:ngram_read_bin_v5` (reader); header macros in
`sent/ngram2.h:196-218`.  Layout per order n (0-based):

  header[512] "julius_bingram_v5\\nword=<2byte|4byte> byteorder=<LE|BE>\\n<user>"
  int n; int dir (0=LR forward, 1=RL backward); u8 bigram_index_reversed
  u32 totalnum[n]
  int wname_len; packed \\0-terminated word names (word id = order)
  per order: u8 is24bit, u8 ct_compaction, u32 bgnlistlen, u32 context_num,
    (n>0) bgn[bgnlistlen] (u32, or 24-bit split), num[bgnlistlen] WORD_ID,
    nnid2wid[totalnum] WORD_ID, prob[totalnum] f32,
    int has_bo -> bo_wt[context_num] f32,
    int has_ctid -> nnid2ctid upper/lower[totalnum]
  int has_bo_wt_1 -> f32[d0.context_num]   (additional forward 2-gram)
  int has_p_2 -> f32[d1.totalnum]

Tuples at order n are grouped by context id; when ct_compaction is off
the context id equals the order-(n-1) tuple id (ngram_access.c
search_ngram_core).  Our writer always emits is24bit=False and
ct_compaction=False — the reference reads that fine (the 24-bit/
compaction forms exist to squeeze 2005-era RAM).  The reader accepts
all v5 variants including byte-swapped and 24-bit files; pre-v5
formats (v3/v4) are not supported.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from julius_tpu_torch.io.arpa import NGramLM, UNK_SYMBOLS

HDSIZE = 512
IDSTR_V5 = b"julius_bingram_v5"
NNID_INVALID = 0xFFFFFFFF
INVALID_UPPER = 255


class _Reader:
    def __init__(self, f, swap: bool):
        self.f = f
        self.swap = swap

    def arr(self, dtype, count) -> np.ndarray:
        dt = np.dtype(dtype)
        buf = self.f.read(dt.itemsize * count)
        if len(buf) != dt.itemsize * count:
            raise ValueError("truncated bingram file")
        a = np.frombuffer(buf, dtype=dt)
        if self.swap and dt.itemsize > 1:
            a = a.byteswap()
        return a

    def u32(self) -> int:
        return int(self.arr(np.uint32, 1)[0])

    def i32(self) -> int:
        return int(self.arr(np.int32, 1)[0])

    def u8(self) -> int:
        return int(self.arr(np.uint8, 1)[0])


def read_bingram(path: str) -> NGramLM:
    with open(path, "rb") as f:
        header = f.read(HDSIZE)
        if not header.startswith(IDSTR_V5):
            raise ValueError(
                "not a v5 bingram (v3/v4 and plain ARPA should go through "
                "io.arpa; reference reads old formats via fallback code "
                "we do not replicate)")
        htext = header.split(b"\xff")[0].decode("latin-1")
        word4 = "4byte" in htext
        big_endian = "byteorder=BE" in htext
        import sys
        swap = big_endian != (sys.byteorder == "big")
        wid_t = np.uint32 if word4 else np.uint16
        r = _Reader(f, swap)

        order = r.i32()
        dirn = r.i32()
        r.u8()   # bigram_index_reversed (old-format hack; always 0 in v5)
        totalnum = [r.u32() for _ in range(order)]
        max_word = totalnum[0]
        wlen = r.i32()
        wbuf = f.read(wlen)
        words = wbuf.split(b"\x00")[:max_word]
        words = [w.decode("utf-8", errors="replace") for w in words]

        probs: List[np.ndarray] = []
        bos: List[Optional[np.ndarray]] = []
        bgns: List[Optional[np.ndarray]] = []
        nums: List[Optional[np.ndarray]] = []
        wids: List[Optional[np.ndarray]] = []
        ctids: List[Optional[np.ndarray]] = []
        for n in range(order):
            is24 = r.u8()
            r.u8()  # ct_compaction (implied by presence of nnid2ctid)
            bgnlistlen = r.u32()
            context_num = r.u32()
            if n > 0:
                if is24:
                    up = r.arr(np.uint8, bgnlistlen).astype(np.uint32)
                    lo = r.arr(np.uint16, bgnlistlen).astype(np.uint32)
                    bgn = np.where(up == INVALID_UPPER, NNID_INVALID,
                                   (up << 16) + lo)
                else:
                    bgn = r.arr(np.uint32, bgnlistlen)
                num = r.arr(wid_t, bgnlistlen).astype(np.int64)
                wid = r.arr(wid_t, totalnum[n]).astype(np.int64)
            else:
                bgn = num = wid = None
            prob = r.arr(np.float32, totalnum[n])
            bo = r.arr(np.float32, context_num) if r.i32() else None
            if r.i32():
                up = r.arr(np.uint8, totalnum[n]).astype(np.uint32)
                lo = r.arr(np.uint16, totalnum[n]).astype(np.uint32)
                ctid = np.where(up == INVALID_UPPER, NNID_INVALID,
                                (up << 16) + lo)
            else:
                ctid = None
            probs.append(prob)
            bos.append(bo)
            bgns.append(bgn)
            nums.append(num)
            wids.append(wid)
            ctids.append(ctid)

        bo_wt_1 = r.arr(np.float32, len(bos[0]) if bos[0] is not None
                        else max_word) if r.i32() else None
        p_2 = r.arr(np.float32, totalnum[1]) if order >= 2 and r.i32() \
            else None

    # ---- rebuild word tuples ------------------------------------------
    ngrams: List[Dict[Tuple[int, ...], Tuple[float, float]]] = [
        {} for _ in range(order)]
    # tuple id -> word tuple, per order
    tuples: List[List[Tuple[int, ...]]] = [[(w,) for w in range(max_word)]]
    for n in range(order):
        cur: List[Tuple[int, ...]] = [None] * totalnum[n] \
            if n > 0 else tuples[0]
        if n > 0:
            # ct -> previous-order tuple id
            if ctids[n - 1] is not None:
                ct2tid = {}
                for tid, ct in enumerate(ctids[n - 1]):
                    if ct != NNID_INVALID:
                        ct2tid[int(ct)] = tid
            else:
                ct2tid = None
            for ct in range(len(bgns[n])):
                b = int(bgns[n][ct])
                if b == NNID_INVALID:
                    continue
                base = tuples[n - 1][ct2tid[ct] if ct2tid else ct]
                for j in range(b, b + int(nums[n][ct])):
                    cur[j] = base + (int(wids[n][j]),)
            tuples.append(cur)
        for tid in range(totalnum[n]):
            tup = cur[tid]
            if tup is None:
                continue
            p = float(probs[n][tid])
            bo = 0.0
            if bos[n] is not None:
                ct = int(ctids[n][tid]) if ctids[n] is not None else tid
                if ct != NNID_INVALID and ct < len(bos[n]):
                    bo = float(bos[n][ct])
            ngrams[n][tup] = (p, bo)

    lm = NGramLM(
        order=order,
        words=words,
        word_index={w: i for i, w in enumerate(words)},
        ngrams=ngrams,
        direction="LR" if dirn == 0 else "RL",
    )
    lm.bos_id = lm.word_index.get("<s>", -1)
    lm.eos_id = lm.word_index.get("</s>", -1)
    for sym in UNK_SYMBOLS:
        if sym in lm.word_index:
            lm.unk_id = lm.word_index[sym]
            break
    if lm.direction == "RL":
        lm.bos_id, lm.eos_id = lm.eos_id, lm.bos_id
    # additional forward 2-gram of an RL model pair (mkbingram -nlr/-nrl)
    if p_2 is not None and lm.direction == "RL":
        fwd: Dict[Tuple[int, int], float] = {}
        for tid, tup in enumerate(tuples[1]):
            if tup is not None:
                # RL tuples are (w, v) reversed; forward prob P(w|v)
                fwd[(tup[1], tup[0])] = float(p_2[tid])
        lm.forward_bigram = fwd          # type: ignore[attr-defined]
        if bo_wt_1 is not None:
            lm.forward_bo_uni = np.asarray(bo_wt_1)  # type: ignore
    return lm


def write_bingram(path: str, lm: NGramLM,
                  header_str: str = "made by julius_tpu") -> None:
    """Write a v5 bingram in the reference's natural-byte-order layout
    (is24bit/ct_compaction off: always accepted by the reference
    reader)."""
    import sys
    order = lm.order
    V = lm.n_words
    wid_t = np.uint16 if V <= 65535 else np.uint32
    wordsize = "2byte(unsigned short)" if wid_t == np.uint16 \
        else "4byte(int)"
    byteorder = "BE" if sys.byteorder == "big" else "LE"

    # sort tuples: order n grouped by context tuple id (lexicographic)
    tup_ids: List[Dict[Tuple[int, ...], int]] = []
    sorted_tuples: List[List[Tuple[int, ...]]] = []
    lvl0 = [(w,) for w in range(V)]
    sorted_tuples.append(lvl0)
    tup_ids.append({t: i for i, t in enumerate(lvl0)})
    for n in range(1, order):
        ts = sorted(lm.ngrams[n].keys(),
                    key=lambda t: (tup_ids[n - 1].get(t[:-1], 1 << 60),
                                   t[-1]))
        for t in ts:
            if t[:-1] not in tup_ids[n - 1]:
                raise ValueError(
                    f"{n+1}-gram {t} has no {n}-gram context entry")
        sorted_tuples.append(ts)
        tup_ids.append({t: i for i, t in enumerate(ts)})

    with open(path, "wb") as f:
        hdr = (IDSTR_V5 + b"\n" + b"word=" + wordsize.encode()
               + b" byteorder=" + byteorder.encode() + b"\n"
               + header_str.encode())
        f.write(hdr[:HDSIZE].ljust(HDSIZE, b"\xff"))
        f.write(struct.pack("ii", order, 0 if lm.direction == "LR" else 1))
        f.write(struct.pack("B", 0))
        for n in range(order):
            f.write(struct.pack("I", len(sorted_tuples[n])))
        names = b"".join(w.encode("utf-8") + b"\x00" for w in lm.words)
        f.write(struct.pack("i", len(names)))
        f.write(names)

        for n in range(order):
            total = len(sorted_tuples[n])
            prevlen = len(sorted_tuples[n - 1]) if n > 0 else 0
            f.write(struct.pack("BB", 0, 0))     # is24bit, ct_compaction
            f.write(struct.pack("II", prevlen, total))
            if n > 0:
                bgn = np.full(prevlen, NNID_INVALID, dtype=np.uint32)
                num = np.zeros(prevlen, dtype=wid_t)
                wid = np.zeros(total, dtype=wid_t)
                for i, t in enumerate(sorted_tuples[n]):
                    ct = tup_ids[n - 1][t[:-1]]
                    if bgn[ct] == NNID_INVALID:
                        bgn[ct] = i
                    num[ct] += 1
                    wid[i] = t[-1]
                f.write(bgn.tobytes())
                f.write(num.tobytes())
                f.write(wid.tobytes())
            prob = np.asarray(
                [lm.ngrams[n].get(t, (-99.0, 0.0))[0]
                 for t in sorted_tuples[n]], np.float32)
            f.write(prob.tobytes())
            if n < order - 1:
                bo = np.asarray(
                    [lm.ngrams[n].get(t, (-99.0, 0.0))[1]
                     for t in sorted_tuples[n]],
                    np.float32)
                f.write(struct.pack("i", 1))
                f.write(bo.tobytes())
            else:
                f.write(struct.pack("i", 0))
            f.write(struct.pack("i", 0))         # no nnid2ctid
        f.write(struct.pack("i", 0))             # no bo_wt_1
        f.write(struct.pack("i", 0))             # no p_2
