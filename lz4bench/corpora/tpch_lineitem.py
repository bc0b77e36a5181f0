"""TPC-H ``lineitem`` as the bodies of Arrow IPC record batches, before
compression: the buffers a Feather V2 or Arrow IPC writer compresses one
LZ4 frame each.

``make(n, rng)`` returns ``n // ROW_BYTES`` rows (at least one) in
record batches of ``BATCH_ROWS`` rows, the last one shorter where the
rows do not fill it.  Each batch holds the 21 non-empty buffers of the
schema (``BUFFERS``), in schema order; each buffer is prefixed by its
length as a little-endian int64, as Arrow prefixes a compressed buffer in
a body, and padded with zeros to a multiple of 8 bytes.  Lineitem has no
nulls, so every validity buffer is empty, and an empty buffer has no
frame and no place here.

The rows follow the TPC-H specification (v3, §4.2.3) at scale factor
1: orders' sparse keys (the first 8 of each 32), 1-7 lines an order,
``l_partkey`` uniform in [1, 200,000], ``l_suppkey`` by the partsupp
rule, ``l_extendedprice = l_quantity × p_retailprice``, discount in
[0.00, 0.10], tax in [0.00, 0.08], the ship, commit and receipt dates
from ``o_orderdate``, the return flag and line status from the current
date 1995-06-17, the four ship instructions and seven ship modes, and
comments of 10-43 characters cut at random places from a text pool
written by the specification's grammar (§4.2.2.10).  The pool is
``POOL_BYTES`` long (the specification's is 300 MB), and each form of a
phrase and each word of a part of speech is equally likely (``dbgen``'s
``dists.dss`` weights them): the configuration lists both as assumed.

The Arrow types: ``l_orderkey``, ``l_partkey`` and ``l_suppkey`` int64;
``l_linenumber`` int32; ``l_quantity``, ``l_extendedprice``,
``l_discount`` and ``l_tax`` decimal128(15, 2) (16-byte little-endian
integers of hundredths); ``l_shipdate``, ``l_commitdate`` and
``l_receiptdate`` date32 (days since 1970-01-01); ``l_returnflag``,
``l_linestatus``, ``l_shipinstruct``, ``l_shipmode`` and ``l_comment``
utf8 (int32 offsets, then the bytes).

A request is a window of the table: the stream ``s`` that
:func:`lz4bench.harness.generator` drew ``rng`` for (the last word of
its seed's entropy) starts at order ``s × rows / 4``, the number of
orders that many rows hold on average, so stream 0 holds the table's
first rows and stream 1 the ones after them.
"""

import itertools

import numpy as np

#: Nominal decoded bytes a row: 3 keys of 8, a line number of 4, 4
#: decimals of 16, 3 dates of 4, 5 string offsets of 4, and the strings'
#: mean bytes (1 + 1 + 12 + 30/7 + 26.5): 168.8, rounded up.
ROW_BYTES = 169
BATCH_ROWS = 65536
SF = 1
POOL_BYTES = 8 << 20

# days since 1970-01-01 (§4.2.3: STARTDATE, CURRENTDATE, ENDDATE)
STARTDATE = 8035          # 1992-01-01
CURRENTDATE = 9298        # 1995-06-17
ENDDATE = 10591           # 1998-12-31

SHIPINSTRUCT = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
SHIPMODE = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

#: The non-empty buffers of a batch in schema order: (column, kind), a
#: kind being a fixed-width type or a utf8 column's ``offsets``/``data``.
BUFFERS = (
    ("l_orderkey", "int64"), ("l_partkey", "int64"), ("l_suppkey", "int64"),
    ("l_linenumber", "int32"), ("l_quantity", "decimal128"),
    ("l_extendedprice", "decimal128"), ("l_discount", "decimal128"),
    ("l_tax", "decimal128"), ("l_returnflag", "offsets"),
    ("l_returnflag", "data"), ("l_linestatus", "offsets"),
    ("l_linestatus", "data"), ("l_shipdate", "date32"),
    ("l_commitdate", "date32"), ("l_receiptdate", "date32"),
    ("l_shipinstruct", "offsets"), ("l_shipinstruct", "data"),
    ("l_shipmode", "offsets"), ("l_shipmode", "data"),
    ("l_comment", "offsets"), ("l_comment", "data"))

# the grammar's word lists (§4.2.2.10)
WORDS = {
    "noun": (
        "foxes", "ideas", "theodolites", "pinto beans", "instructions",
        "dependencies", "excuses", "platelets", "asymptotes", "courts",
        "dolphins", "multipliers", "sauternes", "warthogs", "frets",
        "dinos", "attainments", "somas", "Tiresias", "patterns", "forges",
        "braids", "hockey players", "frays", "warhorses", "dugouts",
        "notornis", "epitaphs", "pearls", "tithes", "waters", "orbits",
        "gifts", "sheaves", "depths", "sentiments", "decoys", "realms",
        "pains", "grouches", "escapades", "packages", "requests",
        "accounts", "deposits"),
    "verb": (
        "sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
        "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
        "sublate", "solve", "thrash", "promise", "engage", "hinder",
        "print", "x-ray", "breach", "eat", "grow", "impress", "mold",
        "poach", "serve", "run", "dazzle", "snooze", "doze", "unwind",
        "kindle", "play", "hang", "believe", "doubt"),
    "adjective": (
        "furious", "sly", "careful", "blithe", "quick", "fluffy", "slow",
        "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
        "stealthy", "permanent", "enticing", "idle", "busy", "regular",
        "final", "ironic", "even", "bold", "silent"),
    "adverb": (
        "sometimes", "always", "never", "furiously", "slyly", "carefully",
        "blithely", "quickly", "fluffily", "slowly", "quietly",
        "ruthlessly", "thinly", "closely", "doggedly", "daringly",
        "bravely", "stealthily", "permanently", "enticingly", "idly",
        "busily", "regularly", "finally", "ironically", "evenly", "boldly",
        "silently"),
    "preposition": (
        "about", "above", "according to", "across", "after", "against",
        "along", "alongside of", "among", "around", "at", "atop", "before",
        "behind", "beneath", "beside", "besides", "between", "beyond",
        "by", "despite", "during", "except", "for", "from", "in place of",
        "inside", "instead of", "into", "near", "of", "on", "outside",
        "over", "past", "since", "through", "throughout", "to", "toward",
        "under", "until", "up", "upon", "without", "with", "within"),
    "auxiliary": (
        "do", "may", "might", "shall", "will", "would", "can", "could",
        "should", "ought to", "must", "will have to", "shall have to",
        "could have to", "should have to", "must have to", "need to",
        "try to"),
    "the": ("the",),
}
TERMINATORS = (".", ";", ":", "?", "!", "--")
# the phrases' forms; "comma" follows the first of two adjectives
_NOUN_PHRASE = (("noun",), ("adjective", "noun"),
                ("adjective", "comma", "adjective", "noun"),
                ("adverb", "adjective", "noun"))
_PHRASES = {
    "NP": _NOUN_PHRASE,
    "VP": (("verb",), ("auxiliary", "verb"), ("verb", "adverb"),
           ("auxiliary", "verb", "adverb")),
    "PP": tuple(("preposition", "the") + f for f in _NOUN_PHRASE),
}
_SENTENCES = (("NP", "VP"), ("NP", "VP", "PP"), ("NP", "VP", "NP"),
              ("NP", "PP", "VP", "NP"), ("NP", "PP", "VP", "PP"))


def _concat(flat: np.ndarray, start: np.ndarray, length: np.ndarray,
            picks: np.ndarray) -> np.ndarray:
    """The pieces ``flat[start[p]:start[p] + length[p]]`` of each ``p`` in
    ``picks``, end to end."""
    out_len = length[picks]
    ends = np.cumsum(out_len)
    total = int(ends[-1]) if ends.size else 0
    idx = np.repeat(start[picks] - (ends - out_len), out_len)
    return flat[idx + np.arange(total)]


def _table(strings) -> tuple:
    """Strings as one flat byte array with each one's start and length."""
    raw = [s.encode() for s in strings]
    length = np.array([len(s) for s in raw], np.int64)
    return (np.frombuffer(b"".join(raw), np.uint8),
            np.cumsum(length) - length, length)


def _sentence_shapes() -> tuple:
    """Every sentence the grammar writes, as its word slots (a part of
    speech, ``comma`` or ``terminator``), with its probability where each
    sentence form and each phrase form is equally likely."""
    shapes, prob = [], []
    for form in _SENTENCES:
        for phrases in itertools.product(*(_PHRASES[p] for p in form)):
            shapes.append(sum(phrases, ()) + ("terminator",))
            prob.append(1 / len(_SENTENCES) / 4 ** len(form))
    return shapes, np.array(prob)


def text_pool(rng: np.random.Generator, size: int = POOL_BYTES
              ) -> np.ndarray:
    """``size`` bytes of the grammar's sentences, words separated by
    single spaces, a comma or terminator right after its word."""
    kinds = list(WORDS) + ["comma", "terminator"]
    tokens, first, count = [], {}, {}
    for kind in kinds:
        words = {"comma": [","], "terminator": list(TERMINATORS)}.get(
            kind) or [" " + w for w in WORDS[kind]]
        first[kind], count[kind] = len(tokens), len(words)
        tokens += words
    flat, start, length = _table(tokens)
    shapes, prob = _sentence_shapes()
    n_slots = np.array([len(s) for s in shapes])
    grid = np.full((len(shapes), n_slots.max()), -1)
    for i, s in enumerate(shapes):
        grid[i, :len(s)] = [kinds.index(k) for k in s]
    mean_bytes = float(prob @ np.array(
        [sum(length[first[k]:first[k] + count[k]].mean() for k in s)
         for s in shapes]))
    pick = rng.choice(len(shapes), int(size / mean_bytes * 1.1) + 64, p=prob)
    slots = grid[pick]
    slots = slots[slots >= 0]
    lo = np.array([first[k] for k in kinds])[slots]
    n = np.array([count[k] for k in kinds])[slots]
    words = lo + (rng.random(slots.size) * n).astype(np.int64)
    out = _concat(flat, start, length, words)
    if out.size < size + 1:
        raise RuntimeError("text pool came out short")
    return out[1:size + 1]            # the first word's space dropped


def _stream(rng: np.random.Generator) -> int:
    """The stream :func:`lz4bench.harness.generator` seeded ``rng`` for;
    0 where its entropy is not that generator's."""
    seq = getattr(rng.bit_generator, "seed_seq", None)
    entropy = getattr(seq, "entropy", None)
    if isinstance(entropy, (list, tuple)) and len(entropy) == 3:
        return int(entropy[2])
    return 0


def lineitem(rows: int, rng: np.random.Generator, first_order: int = 0
             ) -> dict:
    """``rows`` rows of lineitem from order ``first_order`` on: each
    column as a numpy array (decimals in hundredths, dates in days since
    1970-01-01, strings as indices into their lists, comments as
    (offset into ``pool``, length)), and the ``pool``."""
    n_orders = rows // 3 + 64
    lines = rng.integers(1, 8, n_orders)
    ends = np.cumsum(lines)
    used = int(np.searchsorted(ends, rows)) + 1
    order = np.repeat(np.arange(used), lines[:used])[:rows]
    ordinal = first_order + np.arange(used)
    orderkey = (ordinal // 8) * 32 + ordinal % 8 + 1
    orderdate = rng.integers(STARTDATE, ENDDATE - 151 + 1, used)
    s = SF * 10_000
    partkey = rng.integers(1, SF * 200_000 + 1, rows)
    supp_i = rng.integers(0, 4, rows)
    quantity = rng.integers(1, 51, rows)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)
    shipdate = orderdate[order] + rng.integers(1, 122, rows)
    commitdate = orderdate[order] + rng.integers(30, 91, rows)
    receiptdate = shipdate + rng.integers(1, 31, rows)
    returned = rng.integers(0, 2, rows)
    comment_len = rng.integers(10, 44, rows)
    pool = text_pool(rng)
    return {
        "l_orderkey": orderkey[order],
        "l_partkey": partkey,
        "l_suppkey": (partkey + supp_i * (s // 4 + (partkey - 1) // s)) % s
        + 1,
        "l_linenumber": np.arange(rows) - (ends - lines)[order] + 1,
        "l_quantity": quantity * 100,
        "l_extendedprice": quantity * retail,
        "l_discount": rng.integers(0, 11, rows),
        "l_tax": rng.integers(0, 9, rows),
        # "R" or "A" where the line was received by the current date
        "l_returnflag": np.where(receiptdate <= CURRENTDATE,
                                 np.where(returned == 1, b"R", b"A"), b"N"),
        "l_linestatus": np.where(shipdate > CURRENTDATE, b"O", b"F"),
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipinstruct": rng.integers(0, len(SHIPINSTRUCT), rows),
        "l_shipmode": rng.integers(0, len(SHIPMODE), rows),
        "l_comment": (rng.integers(0, POOL_BYTES - comment_len + 1),
                      comment_len),
        "pool": pool,
    }


def _utf8(t: dict, name: str, lo: int, hi: int) -> tuple:
    """The utf8 column ``name`` of rows ``lo:hi``: its int32 offsets and
    its bytes."""
    col = t[name]
    if name == "l_comment":
        flat, start, length = t["pool"], col[0][lo:hi], col[1][lo:hi]
        picks = np.arange(hi - lo)
    elif name in ("l_returnflag", "l_linestatus"):
        return (np.arange(hi - lo + 1, dtype="<i4"),
                col[lo:hi].view(np.uint8))
    else:
        values = SHIPINSTRUCT if name == "l_shipinstruct" else SHIPMODE
        flat, start, length = _table(values)
        picks = col[lo:hi]
    return (np.concatenate([[0], np.cumsum(length[picks])]).astype("<i4"),
            _concat(flat, start, length, picks))


_WIDTH = {"int64": "<i8", "int32": "<i4", "date32": "<i4"}


def batch_buffers(t: dict, lo: int, hi: int) -> list:
    """The buffers (uint8 arrays, ``BUFFERS``'s order) of the batch of
    rows ``lo:hi`` of the table ``t``."""
    strings, out = {}, []
    for name, kind in BUFFERS:
        if kind in ("offsets", "data"):
            if name not in strings:
                strings[name] = _utf8(t, name, lo, hi)
            buf = strings[name][kind == "data"]
        elif kind == "decimal128":   # non-negative: the high word is 0
            buf = np.zeros((hi - lo, 2), "<i8")
            buf[:, 0] = t[name][lo:hi]
        else:
            buf = t[name][lo:hi].astype(_WIDTH[kind])
        out.append(np.ascontiguousarray(buf).view(np.uint8).reshape(-1))
    return out


def body(buffers: list) -> list:
    """Each buffer prefixed by its int64 length and padded to 8 bytes."""
    parts = []
    for b in buffers:
        parts.append(np.frombuffer(np.int64(b.size).astype("<i8").tobytes(),
                                   np.uint8))
        parts.append(b)
        if b.size % 8:
            parts.append(np.zeros(8 - b.size % 8, np.uint8))
    return parts


def make(n: int, rng: np.random.Generator) -> np.ndarray:
    rows = max(1, n // ROW_BYTES)
    t = lineitem(rows, rng, first_order=_stream(rng) * (rows // 4))
    parts = []
    for lo in range(0, rows, BATCH_ROWS):
        parts += body(batch_buffers(t, lo, min(rows, lo + BATCH_ROWS)))
    return np.concatenate(parts)
