"""A zstd frame decoder in pure Python (RFC 8878): the plain version of
``emernerf_torch/native/zstd.cc``.

It covers what a frame may hold short of a dictionary: the frame header
with or without a content size, the window, the optional XXH64 checksum
(verified), raw, RLE and compressed blocks, the literals section (raw, RLE,
Huffman with one or four streams, and treeless sections that reuse the
previous table), the sequences' FSE tables (predefined, RLE, compressed and
repeat) and the three repeat offsets.  Skippable frames are skipped.  A
frame that names a dictionary, and every malformed input this decoder can
see, raises ``ZstdError``.

It is slow (about 1 MB/s): the tests hold the native decoder against it,
and nothing reads a checkpoint through it.

    decompress(data) -> bytes        every frame of ``data``, concatenated
    frame_content_size(data) -> int  the first frame's content size, or -1
    xxh64(data, seed=0) -> int
"""

from __future__ import annotations

from collections import Counter

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 1 << 17
WINDOW_LOG_MAX = 31

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

# (baseline, extra bits) of each literals-length and match-length code
LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
# the predefined distributions: (accuracy log, normalized counts)
LL_DEFAULT = (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                  3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1])
ML_DEFAULT = (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1,
                  -1, -1, -1, -1])
OF_DEFAULT = (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                  -1, -1, -1, -1, -1])
# the largest symbol and accuracy log each table may have
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)


class ZstdError(ValueError):
    pass


# how often each part of the format was decoded (the tests read it to show
# what their payloads exercised)
seen: Counter = Counter()


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _round(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


class _Forward:
    """Bits read from the start of a byte string, least significant first."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.pos, self.end = data, start * 8, end * 8

    def read(self, n: int) -> int:
        if self.pos + n > self.end:
            raise ZstdError("truncated FSE table description")
        lo = self.pos >> 3
        v = int.from_bytes(self.data[lo:((self.pos + n + 7) >> 3)], "little") >> (self.pos & 7)
        self.pos += n
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        pos = self.pos
        n = min(n, self.end - pos)
        v = self.read(n)
        self.pos = pos
        return v

    def byte_end(self) -> int:
        return (self.pos + 7) >> 3


class _Backward:
    """A zstd backward bitstream: bits read from the end, most significant
    first, after the end mark (the highest set bit of the last byte).
    Reading past the start gives zeros and leaves ``left`` negative."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise ZstdError("bitstream without its end mark")
        self.data, self.start = data, start
        self.left = (end - start - 1) * 8 + data[end - 1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.left -= n
        lo = self.left
        if lo < 0:
            n, lo = n + lo, 0
            if n <= 0:
                return 0
            pad = -self.left
        else:
            pad = 0
        b0 = self.start + (lo >> 3)
        b1 = self.start + ((lo + n - 1) >> 3) + 1
        v = (int.from_bytes(self.data[b0:b1], "little") >> (lo & 7)) & ((1 << n) - 1)
        return v << pad

    def peek(self, n: int) -> int:
        left = self.left
        v = self.read(n)
        self.left = left
        return v


def read_fse_description(data: bytes, pos: int, end: int, max_symbol: int, max_log: int):
    """An FSE table description at ``data[pos:]``: (accuracy log,
    normalized counts, the position after it)."""
    br = _Forward(data, pos, end)
    log = br.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ZstdError("FSE description has too many symbols")
        mx = (2 * threshold - 1) - remaining
        v = br.peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            br.read(nbits - 1)
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            br.read(nbits)
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                rep = br.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return log, counts, br.byte_end()


def build_fse_table(log: int, counts):
    """The decoding table of a distribution: (symbol, bits, base) a state."""
    size = 1 << log
    symbol = [0] * size
    nxt = [0] * len(counts)
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    table = []
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return log, table


def _rle_table(symbol: int):
    return 0, [(symbol, 0, 0)]


_DEFAULTS = {"ll": build_fse_table(*LL_DEFAULT), "ml": build_fse_table(*ML_DEFAULT),
             "of": build_fse_table(*OF_DEFAULT)}


def _huffman_weights(data: bytes, pos: int, end: int):
    """The Huffman tree description at ``data[pos:]``: (weights of every
    symbol but the last, the position after it)."""
    if pos >= end:
        raise ZstdError("truncated Huffman tree description")
    head = data[pos]
    pos += 1
    seen["huffman_weights_direct" if head >= 128 else "huffman_weights_fse"] += 1
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        if pos + nbytes > end:
            raise ZstdError("truncated Huffman weights")
        w = []
        for i in range(n):
            b = data[pos + i // 2]
            w.append(b >> 4 if i % 2 == 0 else b & 15)
        return w, pos + nbytes
    if pos + head > end:
        raise ZstdError("truncated Huffman weights")
    log, counts, after = read_fse_description(data, pos, pos + head, 255, 6)
    _, table = build_fse_table(log, counts)
    br = _Backward(data, after, pos + head)
    states = [br.read(log), br.read(log)]
    w = []
    cur = 0
    while True:  # two interleaved states until the stream runs out
        sym, nb, base = table[states[cur]]
        w.append(sym)
        states[cur] = base + br.read(nb)
        if br.left < 0:
            w.append(table[states[1 - cur]][0])
            break
        if len(w) > 255:
            raise ZstdError("too many Huffman weights")
        cur ^= 1
    if len(w) > 255:
        raise ZstdError("too many Huffman weights")
    return w, pos + head


def build_huffman_table(weights):
    """(max bits, table of 2^max bits (symbol, bits)) from the weights of
    every symbol but the last, whose weight completes a power of two."""
    total = sum(1 << (w - 1) for w in weights if w > 0)
    if total == 0 or any(w > 12 for w in weights):
        raise ZstdError("corrupt Huffman weights")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman weights do not complete a power of two")
    if max_bits > 11:
        raise ZstdError("Huffman code longer than 11 bits")
    weights = list(weights) + [rest.bit_length()]
    table = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                table.extend([(s, max_bits + 1 - w)] * (1 << (w - 1)))
    return max_bits, table


def _huffman_stream(data: bytes, start: int, end: int, huf, n: int, out: bytearray):
    max_bits, table = huf
    br = _Backward(data, start, end)
    for _ in range(n):
        s, nb = table[br.peek(max_bits)]
        br.left -= nb
        out.append(s)
    if br.left != 0:
        raise ZstdError("Huffman stream not consumed exactly")


class _Frame:
    def __init__(self):
        self.huf = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, fr: _Frame):
    """The literals section at ``data[pos:]``: (literals, the position
    after it)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    seen[("literals_raw", "literals_rle", "literals_huffman", "literals_treeless")[kind]] += 1
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if size > BLOCK_MAX:
            raise ZstdError("literals above the block size")
        if kind == 0:
            if pos + size > end:
                raise ZstdError("truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ZstdError("truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    nhead = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + nhead > end:
        raise ZstdError("truncated literals header")
    h = int.from_bytes(data[pos:pos + nhead], "little")
    bits = {3: 10, 4: 14, 5: 18}[nhead]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    seen[f"literals_{streams}_stream"] += 1
    pos += nhead
    stop = pos + comp
    if stop > end or regen > BLOCK_MAX:
        raise ZstdError("literals section past its block")
    if kind == 2:
        weights, pos = _huffman_weights(data, pos, stop)
        fr.huf = build_huffman_table(weights)
    elif fr.huf is None:
        raise ZstdError("treeless literals with no previous Huffman table")
    out = bytearray()
    if streams == 1:
        _huffman_stream(data, pos, stop, fr.huf, regen, out)
    else:
        if pos + 6 > stop:
            raise ZstdError("truncated jump table")
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little")
                      for i in range(3))
        pos += 6
        s4 = stop - pos - s1 - s2 - s3
        if s4 < 1:
            raise ZstdError("corrupt jump table")
        per = (regen + 3) // 4
        if 3 * per > regen:
            raise ZstdError("corrupt four-stream literals size")
        for size, n in ((s1, per), (s2, per), (s3, per), (s4, regen - 3 * per)):
            _huffman_stream(data, pos, pos + size, fr.huf, n, out)
            pos += size
    return bytes(out), stop


def _sequences(data: bytes, pos: int, end: int, fr: _Frame):
    """The sequences section: a list of (literals length, offset value,
    match length)."""
    if pos >= end:
        raise ZstdError("truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise ZstdError("truncated sequences section")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the compression modes")
    for name, shift, (max_sym, max_log) in (("ll", 6, LL_MAX), ("of", 4, OF_MAX),
                                            ("ml", 2, ML_MAX)):
        mode = (modes >> shift) & 3
        seen["fse_" + ("predefined", "rle", "compressed", "repeat")[mode]] += 1
        if mode == 0:
            fr.tables[name] = _DEFAULTS[name]
        elif mode == 1:
            if pos >= end or data[pos] > max_sym:
                raise ZstdError("corrupt RLE sequence table")
            fr.tables[name] = _rle_table(data[pos])
            pos += 1
        elif mode == 2:
            log, counts, pos = read_fse_description(data, pos, end, max_sym, max_log)
            fr.tables[name] = build_fse_table(log, counts)
        elif fr.tables[name] is None:
            raise ZstdError("repeat sequence table with no previous table")
    (ll_log, ll), (of_log, of), (ml_log, ml) = (fr.tables[k] for k in ("ll", "of", "ml"))
    br = _Backward(data, pos, end)
    sll, sof, sml = br.read(ll_log), br.read(of_log), br.read(ml_log)
    seqs = []
    for i in range(n):
        of_code, ml_code, ll_code = of[sof][0], ml[sml][0], ll[sll][0]
        if of_code > 31:
            raise ZstdError("offset code above 31")
        offset = (1 << of_code) + br.read(of_code)
        mb, mx = ML_CODES[ml_code]
        mlen = mb + br.read(mx)
        lb, lx = LL_CODES[ll_code]
        llen = lb + br.read(lx)
        seqs.append((llen, offset, mlen))
        if i + 1 < n:
            _, nb, base = ll[sll]
            sll = base + br.read(nb)
            _, nb, base = ml[sml]
            sml = base + br.read(nb)
            _, nb, base = of[sof]
            sof = base + br.read(nb)
    if br.left != 0:
        raise ZstdError("sequence bitstream not consumed exactly")
    return seqs


def _execute(lits: bytes, seqs, fr: _Frame, out: bytearray, frame_start: int,
             window: int):
    reps = fr.reps
    lp = 0
    for llen, value, mlen in seqs:
        if lp + llen > len(lits):
            raise ZstdError("sequence past its literals")
        out += lits[lp:lp + llen]
        lp += llen
        if value > 3:
            offset = value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            seen["repeat_offset"] += 1
            idx = value - 1 + (llen == 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[0] - 1 if idx == 3 else reps[idx]
                if idx > 1:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        have = len(out) - frame_start
        if offset == 0 or offset > have or offset > window:
            raise ZstdError(f"match offset {offset} beyond the {min(have, window)} bytes "
                            "behind it")
        src = len(out) - offset
        if offset >= mlen:
            out += out[src:src + mlen]
        else:
            piece = out[src:]
            reps_n, rest = divmod(mlen, offset)
            out += piece * reps_n + piece[:rest]
    out += lits[lp:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``data[pos:]`` (after its magic) onto ``out``;
    returns the position after it."""
    if pos >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, did_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = None
    if not single:
        wd = data[pos]
        pos += 1
        log = 10 + (wd >> 3)
        if log > WINDOW_LOG_MAX:
            raise ZstdError(f"window log {log} above {WINDOW_LOG_MAX}")
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    if did_size:
        if int.from_bytes(data[pos:pos + did_size], "little"):
            raise ZstdError("the frame names a dictionary")
        pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = -1
    if fcs_size:
        if pos + fcs_size > len(data):
            raise ZstdError("truncated frame header")
        content = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2
                                                                       else 0)
        pos += fcs_size
    seen["content_size" if content >= 0 else "no_content_size"] += 1
    if window is None:
        window = content
    start = len(out)
    fr = _Frame()
    block_max = min(BLOCK_MAX, window)
    while True:
        if pos + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ZstdError("reserved block type")
        seen[("raw_block", "rle_block", "compressed_block")[kind]] += 1
        if size > block_max:
            raise ZstdError(f"block of {size} bytes above the {block_max}-byte limit")
        if kind == 0:
            if pos + size > len(data):
                raise ZstdError("truncated raw block")
            out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise ZstdError("truncated RLE block")
            out += bytes([data[pos]]) * size
            pos += 1
        else:
            end = pos + size
            if end > len(data):
                raise ZstdError("truncated compressed block")
            lits, p = _literals(data, pos, end, fr)
            seqs = _sequences(data, p, end, fr)
            before = len(out)
            _execute(lits, seqs, fr, out, start, window)
            if len(out) - before > BLOCK_MAX:
                raise ZstdError("block decodes above the block size")
            pos = end
        if content >= 0 and len(out) - start > content:
            raise ZstdError("frame decodes past its content size")
        if last:
            break
    if content >= 0 and len(out) - start != content:
        raise ZstdError(f"frame decoded {len(out) - start} bytes, its header says {content}")
    if checksum:
        seen["checksum"] += 1
        if pos + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(out[start:]) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        pos += 4
    return pos


def decompress(data) -> bytes:
    try:
        return _decompress(bytes(data))
    except IndexError as e:  # a length field that points past the input
        raise ZstdError("truncated zstd input") from e


def _decompress(data: bytes) -> bytes:
    out = bytearray()
    pos = 0
    if not data:
        raise ZstdError("empty input")
    while pos < len(data):
        if pos + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic & SKIPPABLE_MASK == SKIPPABLE:
            if pos + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            pos += 4 + int.from_bytes(data[pos:pos + 4], "little")
            if pos > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"bad zstd magic {magic:#010x}")
        pos = _frame(data, pos, out)
    return bytes(out)


def frame_content_size(data) -> int:
    """The first frame's content size from its header, or -1."""
    data = bytes(data[:18])
    if len(data) < 5 or int.from_bytes(data[:4], "little") != MAGIC:
        raise ZstdError("not a zstd frame")
    fhd = data[4]
    single, did_flag, fcs_flag = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[did_flag]
    n = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if n == 0:
        return -1
    if pos + n > len(data):
        raise ZstdError("truncated frame header")
    return int.from_bytes(data[pos:pos + n], "little") + (256 if n == 2 else 0)
