"""Decode zstd frames (RFC 8878) with Python and numpy alone.

The JAX package's orbax checkpoints compress every OCDBT node and every zarr
chunk with zstd, and neither Python's standard library nor the card's host
has a decoder. This module is one, for what a compressor without a
dictionary writes:

- raw, RLE and compressed blocks;
- literals that are raw, RLE, Huffman-coded in 1 or 4 streams, or
  "treeless" (the previous block's Huffman table);
- sequences whose literal-length, offset and match-length codes are
  predefined, RLE, FSE-coded or a repeat of the previous block's tables;
- the three repeat offsets, shifted when a sequence has no literals;
- single-segment frames and frames with a window descriptor, with or without
  a content size;
- several frames back to back, skippable frames skipped;
- the XXH64 content checksum, verified where the frame has one.

``decompress(data)`` returns the concatenated content of every frame in
``data``. A frame that needs a dictionary raises ``ValueError``, as does a
truncated or corrupt frame or bytes left over after the last frame; no call
returns partial output.

numpy does the bulk work: raw and RLE blocks and long match copies are slice
assignments into one numpy buffer per frame, and a Huffman stream is decoded
by computing, for every bit position at once, the symbol and the bit count a
lookup there gives, so the sequential part is a chase of "next position"
pointers. The FSE state machines of the sequences stay a Python loop.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["decompress", "xxh64"]

MAGIC = 0xFD2FB528
SKIPPABLE, SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0
BLOCK_MAX = 1 << 17
_M64 = (1 << 64) - 1

# literal-length and match-length codes: (baseline, extra bits)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# the predefined distributions (RFC 8878 3.1.1.3.2.2) and their accuracy logs
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
                1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
                -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1], 5)
# (largest symbol, largest accuracy log) of each FSE table kind
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS, _WEIGHT_LIMITS = (35, 9), (31, 8), (52, 9), (12, 6)
_HUF_MAX_BITS = 12
_HOPS = 4                 # Huffman symbols per step of the Python loop


def decompress(data: bytes | bytearray | memoryview) -> bytes:
    """The content of every zstd frame in ``data``, concatenated."""
    view = memoryview(data).cast("B")
    if not len(view):
        raise ValueError("zstd: no frame in empty input")
    parts, pos = [], 0
    while pos < len(view):
        if len(view) - pos < 8:
            raise ValueError(f"zstd: {len(view) - pos} bytes left over after the last frame")
        magic = int.from_bytes(view[pos:pos + 4], "little")
        if magic == MAGIC:
            content, pos = _frame(view, pos + 4)
            parts.append(content)
        elif magic & SKIPPABLE_MASK == SKIPPABLE:
            size = int.from_bytes(view[pos + 4:pos + 8], "little")
            pos += 8 + size
            if pos > len(view):
                raise ValueError("zstd: skippable frame truncated")
        else:
            raise ValueError(f"zstd: bytes at offset {pos} are not a frame (magic 0x{magic:08x})")
    return b"".join(parts)


# ------------------------------------------------------------------ frames
class _Output:
    """One frame's content: a numpy buffer, grown when the frame does not
    state its size."""

    def __init__(self, size: int | None):
        self.fixed = size is not None
        self.buf = np.empty(size if self.fixed else BLOCK_MAX, np.uint8)
        self.mv = memoryview(self.buf)
        self.n = 0

    def reserve(self, k: int) -> None:
        need = self.n + k
        if need <= len(self.buf):
            return
        if self.fixed:
            raise ValueError("zstd: frame content exceeds its stated size")
        self.buf = np.resize(self.buf, max(need, 2 * len(self.buf)))
        self.mv = memoryview(self.buf)


class _FrameState:
    def __init__(self) -> None:
        self.huffman: tuple | None = None     # the last Huffman table
        self.tables: dict[str, tuple] = {}     # the last LL / OF / ML FSE tables
        self.reps = [1, 4, 8]


def _frame(view: memoryview, pos: int) -> tuple[bytes, int]:
    """(content, end offset) of the frame whose header starts at ``pos``."""
    end = len(view)

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > end:
            raise ValueError("zstd: frame truncated")
        out = view[pos:pos + n]
        pos += n
        return out

    fhd = take(1)[0]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 0x08:
        raise ValueError("zstd: reserved bit set in the frame header")
    window = None
    if not single:
        wd = take(1)[0]
        log = 10 + (wd >> 3)
        window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
    dict_id = int.from_bytes(take((0, 1, 2, 4)[dict_flag]), "little")
    if dict_id:
        raise ValueError(f"zstd: frame needs dictionary {dict_id}, which this decoder lacks")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = int.from_bytes(take(fcs_size), "little") + (256 if fcs_size == 2 else 0)
    size = size if fcs_size else None
    # every block of at most 128 KiB takes at least 4 bytes (an RLE block)
    if size is not None and size > (end - pos) // 4 * BLOCK_MAX + BLOCK_MAX:
        raise ValueError(f"zstd: frame states {size} bytes of content, more than its "
                         f"{end - pos} bytes can hold")
    block_max = BLOCK_MAX if window is None else min(window, BLOCK_MAX)
    out, state = _Output(size), _FrameState()
    last = 0
    while not last:
        header = int.from_bytes(take(3), "little")
        last, kind, bsize = header & 1, (header >> 1) & 3, header >> 3
        if bsize > block_max:
            raise ValueError(f"zstd: block of {bsize} bytes, above the {block_max} maximum")
        if kind == 1:
            out.reserve(bsize)
            out.buf[out.n:out.n + bsize] = take(1)[0]
            out.n += bsize
        elif kind == 0:
            out.reserve(bsize)
            out.mv[out.n:out.n + bsize] = take(bsize)
            out.n += bsize
        elif kind == 2:
            _compressed_block(take(bsize), state, out)
        else:
            raise ValueError("zstd: reserved block type")
    if size is not None and out.n != size:
        raise ValueError(f"zstd: frame holds {out.n} bytes of content, its header says {size}")
    content = out.mv[:out.n]
    if checksum:
        stored = int.from_bytes(take(4), "little")
        if xxh64(content) & 0xFFFFFFFF != stored:
            raise ValueError("zstd: content checksum mismatch")
    return bytes(content), pos


# ------------------------------------------------------------------ blocks
def _compressed_block(block: memoryview, state: _FrameState, out: _Output) -> None:
    lits, pos = _literals(block, state)
    n = len(block)
    if pos >= n:
        raise ValueError("zstd: compressed block without its sequences section")
    b0 = block[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > n:
            raise ValueError("zstd: sequences header truncated")
        nseq, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        if pos + 3 > n:
            raise ValueError("zstd: sequences header truncated")
        nseq, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != n:
            raise ValueError("zstd: bytes after a block's literals with no sequences")
        out.reserve(len(lits))
        out.mv[out.n:out.n + len(lits)] = lits
        out.n += len(lits)
        return
    if pos >= n:
        raise ValueError("zstd: sequences header truncated")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the symbol compression modes")
    tables = []
    for name, shift, default, limits in (("ll", 6, _LL_DEFAULT, _LL_LIMITS),
                                         ("of", 4, _OF_DEFAULT, _OF_LIMITS),
                                         ("ml", 2, _ML_DEFAULT, _ML_LIMITS)):
        mode = (modes >> shift) & 3
        if mode == 0:
            table = _predefined(name)
        elif mode == 1:
            if pos >= n:
                raise ValueError("zstd: RLE symbol missing")
            if block[pos] > limits[0]:
                raise ValueError(f"zstd: RLE {name} code {block[pos]} out of range")
            table = ([block[pos]], [0], [0], 0)
            pos += 1
        elif mode == 2:
            counts, al, used = _read_distribution(block[pos:], *limits)
            table = _fse_table(tuple(counts), al)
            pos += used
        else:
            if name not in state.tables:
                raise ValueError(f"zstd: repeated {name} table with none before it")
            table = state.tables[name]
        state.tables[name] = table
        tables.append(table)
    lls, mls, ofs = _sequences(block[pos:], nseq, *tables)
    _execute(lits, lls, mls, ofs, state.reps, out)


def _literals(block: memoryview, state: _FrameState) -> tuple[memoryview | bytes, int]:
    """(literals, bytes of the section) of a compressed block."""
    n = len(block)
    if not n:
        raise ValueError("zstd: empty compressed block")
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        head = (1, 2, 1, 3)[fmt]
        if head > n:
            raise ValueError("zstd: literals header truncated")
        v = int.from_bytes(block[:head], "little")
        size = v >> (3 if head == 1 else 4)
        if size > BLOCK_MAX:
            raise ValueError(f"zstd: {size} literals in one block")
        if kind == 0:
            if head + size > n:
                raise ValueError("zstd: raw literals truncated")
            return block[head:head + size], head + size
        if head + 1 > n:
            raise ValueError("zstd: RLE literal missing")
        return bytes(block[head:head + 1]) * size, head + 1
    head, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[fmt]
    if head > n:
        raise ValueError("zstd: literals header truncated")
    v = int.from_bytes(block[:head], "little")
    mask = (1 << bits) - 1
    regen, csize = (v >> 4) & mask, (v >> (4 + bits)) & mask
    if regen > BLOCK_MAX:
        raise ValueError(f"zstd: {regen} literals in one block")
    if head + csize > n:
        raise ValueError("zstd: compressed literals truncated")
    data = block[head:head + csize]
    if kind == 2:
        table, used = _huffman_table(data)
        state.huffman, data = table, data[used:]
    elif state.huffman is None:
        raise ValueError("zstd: treeless literals with no Huffman table before them")
    table = state.huffman
    if fmt == 0:
        lits = _huffman_stream(data, regen, *table)
    else:
        if len(data) < 6:
            raise ValueError("zstd: Huffman jump table truncated")
        s1, s2, s3 = (int.from_bytes(data[i:i + 2], "little") for i in (0, 2, 4))
        s4 = len(data) - 6 - s1 - s2 - s3
        if s4 < 0:
            raise ValueError("zstd: Huffman streams larger than the literals section")
        each = (regen + 3) // 4
        counts = (each, each, each, regen - 3 * each)
        if counts[3] < 0:
            raise ValueError(f"zstd: {regen} literals cannot fill four streams")
        bounds = np.cumsum([6, s1, s2, s3, s4]).tolist()
        lits = np.concatenate([
            _huffman_stream(data[bounds[i]:bounds[i + 1]], counts[i], *table)
            for i in range(4)])
    return memoryview(lits), head + csize


def _execute(lits, lls: list, mls: list, ofs: list, reps: list, out: _Output) -> None:
    """Copy the literals and matches of one block's sequences into ``out``."""
    if sum(lls) > len(lits):
        raise ValueError("zstd: sequences use more literals than the block holds")
    total = len(lits) + sum(mls)
    if total > BLOCK_MAX:
        raise ValueError(f"zstd: block decodes to {total} bytes")
    out.reserve(total)
    buf, mv, o, lp = out.buf, out.mv, out.n, 0
    r1, r2, r3 = reps
    for ll, ml, ofv in zip(lls, mls, ofs):
        if ofv > 3:
            off = ofv - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = ofv - (ll != 0)      # 0..3: rep1, rep2, rep3, rep1 - 1
            if idx == 0:
                off = r1
            elif idx == 1:
                off = r2
                r1, r2 = r2, r1
            elif idx == 2:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                r1, r2, r3 = off, r1, r2
        if ll:
            mv[o:o + ll] = lits[lp:lp + ll]
            o += ll
            lp += ll
        if off > o or off <= 0:
            raise ValueError(f"zstd: match offset {off} reaches before the frame's start")
        src = o - off
        if off >= ml:
            mv[o:o + ml] = mv[src:src + ml]
        elif ml > 64:
            buf[o:o + ml] = np.resize(buf[src:o], ml)
        else:
            mv[o:o + ml] = (bytes(mv[src:o]) * (ml // off + 1))[:ml]
        o += ml
    rest = len(lits) - lp
    mv[o:o + rest] = lits[lp:]
    out.n = o + rest
    reps[:] = r1, r2, r3


# ------------------------------------------------------------------ Huffman
def _huffman_table(data: memoryview) -> tuple[tuple, int]:
    """((symbols, bit counts, max bits), bytes used) of a Huffman tree
    description: per-position lookup arrays of ``2 ** max_bits`` entries."""
    if not len(data):
        raise ValueError("zstd: Huffman tree description missing")
    head = data[0]
    if head < 128:
        if 1 + head > len(data):
            raise ValueError("zstd: Huffman weights truncated")
        weights = _fse_weights(data[1:1 + head])
        used = 1 + head
    else:
        count = head - 127
        used = 1 + (count + 1) // 2
        if used > len(data):
            raise ValueError("zstd: Huffman weights truncated")
        weights = [(data[1 + i // 2] >> (0 if i & 1 else 4)) & 15 for i in range(count)]
    if len(weights) > 255:
        raise ValueError("zstd: more than 255 Huffman weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise ValueError("zstd: Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > _HUF_MAX_BITS:
        raise ValueError("zstd: Huffman weights do not form a prefix code")
    weights.append(rest.bit_length())
    if max(weights) > max_bits:
        raise ValueError("zstd: Huffman weight above the table's depth")
    size = 1 << max_bits
    symbols, nbits = np.zeros(size, np.uint8), np.zeros(size, np.int32)
    start = 0
    ws = np.asarray(weights)
    for w in range(1, max_bits + 1):
        for s in np.flatnonzero(ws == w).tolist():
            span = 1 << (w - 1)
            symbols[start:start + span] = s
            nbits[start:start + span] = max_bits + 1 - w
            start += span
    return (symbols, nbits, max_bits), used


def _huffman_stream(data: memoryview, count: int, symbols: np.ndarray, nbits: np.ndarray,
                    max_bits: int) -> np.ndarray:
    """``count`` literals of one backward Huffman stream.

    Every bit position gets its table lookup at once (the ``max_bits`` bits
    below it, zeros past the start), which gives the position the next
    lookup starts from. Jumps of ``_HOPS`` symbols are composed from those,
    so the Python loop takes one step per ``_HOPS`` symbols; numpy fills in
    the positions between."""
    a = np.frombuffer(data, np.uint8)
    if not a.size or not a[-1]:
        raise ValueError("zstd: Huffman stream without its end marker")
    total = 8 * (a.size - 1) + int(a[-1]).bit_length() - 1
    # 32-bit little-endian words at every byte offset, two zero bytes in front
    pad = np.zeros(a.size + 6, np.uint32)
    pad[2:2 + a.size] = a
    words = pad[:-3] | pad[1:-2] << 8 | pad[2:-1] << 16 | pad[3:] << 24
    shifted = (words[:, None] >> np.arange(8, dtype=np.uint32)) & np.uint32((1 << max_bits) - 1)
    window = shifted.reshape(-1)[16 - max_bits:17 - max_bits + total]
    # step[p]: where the lookup at p leaves the stream; -1 (the last slot,
    # which maps to itself) marks a read past the start
    step = np.arange(total + 2, dtype=np.int32)
    step[:-1] -= np.take(nbits, window)
    np.maximum(step, -1, out=step)
    step[-1] = -1
    jump = step
    for _ in range(_HOPS.bit_length() - 1):
        jump = np.take(jump, jump)
    chase = memoryview(jump)
    starts, p = [0] * (count // _HOPS + 1), total
    for i in range(len(starts)):
        starts[i] = p
        p = chase[p]
    path = np.empty((len(starts), _HOPS), np.int32)
    path[:, 0] = starts
    for j in range(1, _HOPS):
        path[:, j] = np.take(step, path[:, j - 1])
    path = path.reshape(-1)
    end = path[count] if count < path.size else step[path[-1]]
    if end != 0:
        raise ValueError("zstd: Huffman stream not consumed exactly")
    return np.take(symbols, np.take(window, path[:count]))


def _fse_weights(data: memoryview) -> list[int]:
    """The Huffman weights of an FSE-compressed description: two states
    decoded alternately until the stream is over-read."""
    counts, al, used = _read_distribution(data, *_WEIGHT_LIMITS)
    sym, nb, base, _ = _fse_table(tuple(counts), al)
    rd = _BackReader(data[used:])
    s1, s2 = rd.read(al), rd.read(al)
    out = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + rd.read(nb[s1])
        if rd.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + rd.read(nb[s2])
        if rd.pos < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ValueError("zstd: Huffman weights stream too long")
    return out


# ------------------------------------------------------------------ FSE
class _BackReader:
    """A backward bit stream (its last byte holds the end marker): ``read(n)``
    takes the next ``n`` bits, zeros once the start is passed (``pos`` < 0)."""

    def __init__(self, data: memoryview):
        if not len(data) or not data[-1]:
            raise ValueError("zstd: bit stream without its end marker")
        self.words = _words(data)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if not n:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            return (self.words[p >> 3] >> (p & 7)) & ((1 << n) - 1)
        if p + n <= 0:
            return 0
        return (self.words[0] & ((1 << (p + n)) - 1)) << -p


def _words(data: memoryview) -> list[int]:
    """The little-endian 64-bit word at every byte offset of ``data``."""
    a = np.zeros(len(data) + 8, np.uint64)
    a[:len(data)] = np.frombuffer(data, np.uint8)
    w = np.zeros(len(data), np.uint64)
    for k in range(8):
        w |= a[k:k + len(data)] << np.uint64(8 * k)
    return w.tolist()


def _read_distribution(data: memoryview, max_symbol: int, max_log: int
                       ) -> tuple[list[int], int, int]:
    """(normalized counts, accuracy log, bytes used) of an FSE table
    description (RFC 8878 4.1.1)."""
    if not len(data):
        raise ValueError("zstd: FSE table description missing")
    head = bytes(data[:1024])
    stream = int.from_bytes(head, "little")
    limit = 8 * len(head)
    al = (stream & 15) + 5
    if al > max_log:
        raise ValueError(f"zstd: FSE accuracy log {al} above {max_log}")
    bit = 4
    remaining, threshold, nbits = (1 << al) + 1, 1 << al, al + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            while True:
                rep = (stream >> bit) & 3
                bit += 2
                counts += [0] * rep
                if rep != 3:
                    break
                if bit > limit:
                    raise ValueError("zstd: FSE table description truncated")
            if len(counts) > max_symbol:
                break
        top = (2 * threshold - 1) - remaining
        low = (stream >> bit) & (threshold - 1)
        if low < top:
            value, bit = low, bit + nbits - 1
        else:
            value = (stream >> bit) & (2 * threshold - 1)
            if value >= threshold:
                value -= top
            bit += nbits
        count = value - 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold and threshold > 1:
            nbits -= 1
            threshold >>= 1
    used = (bit + 7) // 8
    if remaining != 1 or len(counts) > max_symbol + 1 or used > len(data):
        raise ValueError("zstd: corrupt FSE table description")
    return counts, al, used


@functools.lru_cache(maxsize=256)
def _fse_table(counts: tuple, al: int) -> tuple[list, list, list, int]:
    """(symbol, bits to read, state base, accuracy log) per state of the
    FSE decoding table of a normalized distribution."""
    size = 1 << al
    sym = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p:
        raise ValueError("zstd: FSE distribution does not fill its table")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb[u] = al - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return sym, nb, base, al


@functools.cache
def _predefined(name: str) -> tuple:
    counts, al = {"ll": _LL_DEFAULT, "of": _OF_DEFAULT, "ml": _ML_DEFAULT}[name]
    return _fse_table(tuple(counts), al)


def _sequences(data: memoryview, nseq: int, ll_t: tuple, of_t: tuple, ml_t: tuple
               ) -> tuple[list, list, list]:
    """(literal lengths, match lengths, offset values) of ``nseq`` sequences."""
    ll_sym, ll_nb, ll_base, ll_al = ll_t
    of_sym, of_nb, of_base, of_al = of_t
    ml_sym, ml_nb, ml_base, ml_al = ml_t
    if not len(data) or not data[-1]:
        raise ValueError("zstd: sequences bit stream without its end marker")
    words = _words(data)
    pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(n: int) -> int:
        nonlocal pos
        pos -= n
        if pos < 0:
            raise ValueError("zstd: sequences bit stream over-read")
        return (words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)

    s_ll, s_of, s_ml = read(ll_al), read(of_al), read(ml_al)
    lls, mls, ofs = [0] * nseq, [0] * nseq, [0] * nseq
    ll_base_v, ll_bits_v, ml_base_v, ml_bits_v = _LL_BASE, _LL_BITS, _ML_BASE, _ML_BITS
    last = nseq - 1
    for i in range(nseq):
        ofc, mlc, llc = of_sym[s_of], ml_sym[s_ml], ll_sym[s_ll]
        if ofc > 31:
            raise ValueError(f"zstd: offset code {ofc} out of range")
        ofs[i] = (1 << ofc) + (read(ofc) if ofc else 0)
        mb = ml_bits_v[mlc]
        mls[i] = ml_base_v[mlc] + (read(mb) if mb else 0)
        lb = ll_bits_v[llc]
        lls[i] = ll_base_v[llc] + (read(lb) if lb else 0)
        if i != last:
            n = ll_nb[s_ll]
            s_ll = ll_base[s_ll] + (read(n) if n else 0)
            n = ml_nb[s_ml]
            s_ml = ml_base[s_ml] + (read(n) if n else 0)
            n = of_nb[s_of]
            s_of = of_base[s_of] + (read(n) if n else 0)
    if pos != 0:
        raise ValueError("zstd: sequences bit stream not consumed exactly")
    return lls, mls, ofs


# ------------------------------------------------------------------ XXH64
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data: bytes | bytearray | memoryview) -> int:
    """XXH64 of ``data``, seed 0 (the hash whose low 32 bits close a zstd frame)."""
    view = memoryview(data).cast("B")
    n, p = len(view), 0
    if n >= 32:
        v1, v2, v3, v4 = (_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64
        stripes = n // 32
        for a, b, c, d in np.frombuffer(view[:32 * stripes], "<u8").reshape(-1, 4).tolist():
            v1, v2, v3, v4 = _round(v1, a), _round(v2, b), _round(v3, c), _round(v4, d)
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57)) + ((v3 << 12) | (v3 >> 52))
             + ((v4 << 18) | (v4 >> 46))) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = 32 * stripes
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(view[p:p + 8], "little"))
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(view[p:p + 4], "little") * _P1 & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= view[p] * _P5 & _M64
        h = (((h << 11) | (h >> 53)) & _M64) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)
