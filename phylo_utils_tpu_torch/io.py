"""Alignment and tree I/O + site-pattern compression (host-side numpy).

Copied from ``phylo_utils_tpu.io`` so the port never imports the JAX
package: a self-contained Newick parser, FASTA/PHYLIP/NEXUS readers, and
pattern compression. Identical alignment columns are collapsed to unique
patterns with integer weights so logL = sum_p w_p * lnL_p.

Not ported yet: the native C++ pattern path (``phylo_utils_tpu.native``)
and codon encoding; ``compress_patterns`` uses ``np.unique`` and raises
``NotImplementedError`` for a codon alphabet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from phylo_utils_tpu_torch import trees as _trees

__all__ = [
    "parse_newick",
    "write_newick",
    "read_fasta",
    "read_phylip",
    "read_alignment",
    "read_nexus",
    "compress_patterns",
    "CompressedAlignment",
]

# ---------------------------------------------------------------------------
# Newick
# ---------------------------------------------------------------------------

class NewickError(ValueError):
    pass


def _tokenize_newick(text: str):
    """Yield newick tokens; handles quoted labels and [...] comments."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif c in "(),;:":
            yield c
            i += 1
        elif c == "[":  # comment — skip to matching ]
            depth = 1
            i += 1
            while i < n and depth:
                if text[i] == "[":
                    depth += 1
                elif text[i] == "]":
                    depth -= 1
                i += 1
            if depth:
                raise NewickError("unterminated [comment]")
        elif c == "'":
            j = i + 1
            buf = []
            while j < n:
                if text[j] == "'":
                    if j + 1 < n and text[j + 1] == "'":  # escaped quote
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            else:
                raise NewickError("unterminated quoted label")
            yield ("LABEL", "".join(buf))
            i = j + 1
        else:
            j = i
            while j < n and text[j] not in "(),;:[" and not text[j].isspace():
                j += 1
            yield ("LABEL", text[i:j])
            i = j


def parse_newick(text: str) -> "_trees.Tree":
    """Parse a single Newick tree string into a :class:`trees.Tree`.

    Supports arbitrary multifurcations (incl. the conventional trifurcating
    root of unrooted trees), branch lengths, internal labels, quoted labels,
    and bracketed comments.
    """
    tokens = list(_tokenize_newick(text))
    if not tokens:
        raise NewickError("empty newick string")

    builder = _trees.TreeBuilder()
    pos = 0

    def peek():
        return tokens[pos] if pos < len(tokens) else None

    def parse_clade() -> int:
        nonlocal pos
        children: List[int] = []
        if peek() == "(":
            pos += 1
            while True:
                children.append(parse_clade())
                tok = peek()
                if tok == ",":
                    pos += 1
                    continue
                if tok == ")":
                    pos += 1
                    break
                raise NewickError(f"expected ',' or ')' near token {pos}")
        # optional label
        name: Optional[str] = None
        tok = peek()
        if isinstance(tok, tuple) and tok[0] == "LABEL":
            name = tok[1]
            pos += 1
        # optional :length
        length: Optional[float] = None
        if peek() == ":":
            pos += 1
            tok = peek()
            if not (isinstance(tok, tuple) and tok[0] == "LABEL"):
                raise NewickError("expected branch length after ':'")
            length = float(tok[1])
            pos += 1
        if not children and name is None:
            raise NewickError("leaf without a name")
        return builder.add_node(name=name, length=length, children=children)

    root = parse_clade()
    if peek() == ";":
        pos += 1
    if pos != len(tokens):
        raise NewickError(f"trailing tokens after tree: {tokens[pos:]}")
    return builder.build(root)


def _quote_label(label: str) -> str:
    """Quote a Newick label when it contains structural characters, so the
    output always round-trips through parse_newick."""
    if label and any(c in label for c in "()[]':;, \t\n"):
        return "'" + label.replace("'", "''") + "'"
    return label


def write_newick(tree: "_trees.Tree", lengths: Optional[np.ndarray] = None) -> str:
    """Serialize a Tree back to Newick (branch lengths from the tree or
    an override vector indexed by node id)."""
    lens = tree.lengths if lengths is None else np.asarray(lengths)

    def fmt(node: int) -> str:
        kids = tree.children[node]
        if kids:
            inner = ",".join(fmt(k) for k in kids)
            label = _quote_label(tree.names[node] or "")
            s = f"({inner}){label}"
        else:
            s = _quote_label(tree.names[node])
        if node != tree.root:
            s += f":{lens[node]:.10g}"
        return s

    return fmt(tree.root) + ";"


# ---------------------------------------------------------------------------
# Alignment readers
# ---------------------------------------------------------------------------

def _maybe_read(path_or_text: str) -> str:
    if "\n" not in path_or_text and os.path.exists(path_or_text):
        with open(path_or_text) as fh:
            return fh.read()
    return path_or_text


def read_fasta(path_or_text: str) -> Dict[str, str]:
    text = _maybe_read(path_or_text)
    seqs: Dict[str, List[str]] = {}
    name = None
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            name = line[1:].split()[0]
            if name in seqs:
                raise ValueError(f"duplicate sequence name {name!r}")
            seqs[name] = []
        else:
            if name is None:
                raise ValueError("FASTA sequence data before first '>' header")
            seqs[name].append(line)
    return {k: "".join(v) for k, v in seqs.items()}


def read_phylip(path_or_text: str) -> Dict[str, str]:
    """Relaxed PHYLIP: sequential (incl. line-wrapped sequences) or
    interleaved. The two layouts are ambiguous in general, so the
    sequential interpretation (a new taxon starts only once the previous
    one's sequence is complete) is tried first and the classic interleaved
    interpretation (first ntax lines are name lines, then blocks cycle)
    is the fallback."""
    text = _maybe_read(path_or_text)
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty phylip input")
    header = lines[0].split()
    ntax, nchar = int(header[0]), int(header[1])

    def _validate(seqs: Dict[str, List[str]]) -> Dict[str, str]:
        out = {k: "".join(v) for k, v in seqs.items()}
        if len(out) != ntax:
            raise ValueError(f"found {len(out)} taxa, header says {ntax}")
        for k, v in out.items():
            if len(v) != nchar:
                raise ValueError(
                    f"sequence {k!r} length {len(v)} != header {nchar}"
                )
        return out

    def _sequential() -> Dict[str, str]:
        names: List[str] = []
        seqs: Dict[str, List[str]] = {}
        for ln in lines[1:]:
            parts = ln.split()
            done = names and sum(map(len, seqs[names[-1]])) >= nchar
            if len(names) < ntax and (not names or done):
                nm = parts[0]
                if nm in seqs:
                    raise ValueError(f"duplicate taxon {nm!r}")
                names.append(nm)
                seqs[nm] = ["".join(parts[1:])]
            else:
                seqs[names[-1]].append("".join(parts))
        return _validate(seqs)

    def _interleaved() -> Dict[str, str]:
        names: List[str] = []
        seqs: Dict[str, List[str]] = {}
        idx = 0
        for ln in lines[1:]:
            parts = ln.split()
            if len(names) < ntax:
                nm = parts[0]
                names.append(nm)
                seqs[nm] = ["".join(parts[1:])]
            else:
                seqs[names[idx % ntax]].append("".join(parts))
                idx += 1
        return _validate(seqs)

    try:
        return _sequential()
    except (ValueError, IndexError):
        return _interleaved()


def read_alignment(path: str) -> Dict[str, str]:
    text = _maybe_read(path)
    stripped = text.lstrip()
    if stripped.startswith(">"):
        return read_fasta(text)
    if stripped[:6].upper() == "#NEXUS":
        return read_nexus(text)["alignment"]
    return read_phylip(text)


# ---------------------------------------------------------------------------
# NEXUS (pragmatic subset: DATA/CHARACTERS matrix + TREES with TRANSLATE)
# ---------------------------------------------------------------------------

def _strip_nexus_comments(text: str) -> str:
    out = []
    depth = 0
    in_quote = False
    for c in text:
        if in_quote:
            out.append(c)
            if c == "'":
                in_quote = False
        elif depth:
            if c == "[":
                depth += 1
            elif c == "]":
                depth -= 1
        elif c == "[":
            depth += 1
        elif c == "'":
            in_quote = True
            out.append(c)
        else:
            out.append(c)
    return "".join(out)


def _split_name_chunks(line: str):
    """(name, [sequence chunks]) for one matrix line; quoted names kept."""
    line = line.strip()
    if not line:
        return None, []
    if line.startswith("'"):
        j = 1
        buf = []
        while j < len(line):
            if line[j] == "'":
                if j + 1 < len(line) and line[j + 1] == "'":
                    buf.append("'")
                    j += 2
                    continue
                break
            buf.append(line[j])
            j += 1
        return "".join(buf), line[j + 1:].split()
    parts = line.split()
    return parts[0], parts[1:]


def read_nexus(path_or_text: str) -> Dict[str, object]:
    """Read a NEXUS file: ``{"alignment": {name: seq}, "trees":
    {name: Tree}}`` (either may be empty).

    Covers the common core: DATA/CHARACTERS blocks (DIMENSIONS, FORMAT
    incl. INTERLEAVE and MATCHCHAR, line-oriented MATRIX — every matrix
    line starts with its taxon name) and TREES blocks (TRANSLATE tables;
    quoted labels; [comments] stripped everywhere).
    """
    text = _maybe_read(path_or_text)
    if text.lstrip()[:6].upper() != "#NEXUS":
        raise ValueError("not a NEXUS file (missing #NEXUS header)")
    text = _strip_nexus_comments(text)
    body = text.lstrip()[6:]
    statements = [s for s in body.split(";") if s.strip()]
    alignment: Dict[str, str] = {}
    trees: Dict[str, "_trees.Tree"] = {}
    block = None
    nchar = None
    matchchar = None
    translate: Dict[str, str] = {}
    for st in statements:
        words = st.split()
        if not words:
            continue
        head = words[0].upper()
        if head == "BEGIN":
            block = words[1].upper() if len(words) > 1 else None
            if block in ("DATA", "CHARACTERS"):
                nchar, matchchar = None, None
            if block == "TREES":
                translate = {}
            continue
        if head in ("END", "ENDBLOCK"):
            block = None
            continue
        if block in ("DATA", "CHARACTERS"):
            if head == "DIMENSIONS":
                for w in words[1:]:
                    k, _, v = w.partition("=")
                    if k.upper() == "NCHAR" and v:
                        nchar = int(v.rstrip())
            elif head == "FORMAT":
                for w in words[1:]:
                    k, _, v = w.partition("=")
                    if k.upper() == "MATCHCHAR" and v:
                        matchchar = v.strip("'")
            elif head == "MATRIX":
                # drop everything through the MATRIX keyword itself
                cut = st.upper().find("MATRIX") + len("MATRIX")
                lines = st[cut:].split("\n")
                seqs: Dict[str, List[str]] = {}
                order: List[str] = []
                for ln in lines:
                    name, chunks = _split_name_chunks(ln)
                    if name is None:
                        continue
                    if name not in seqs:
                        seqs[name] = []
                        order.append(name)
                    seqs[name].append("".join(chunks))
                ref = None
                for name in order:
                    s = "".join(seqs[name])
                    if matchchar and ref is not None:
                        s = "".join(
                            ref[k] if ch == matchchar and k < len(ref)
                            else ch
                            for k, ch in enumerate(s)
                        )
                    else:
                        ref = s
                    alignment[name] = s
                lens = {len(s) for s in alignment.values()}
                if nchar is not None and lens != {nchar}:
                    raise ValueError(
                        f"NEXUS matrix rows have lengths {sorted(lens)}; "
                        f"expected nchar={nchar}"
                    )
        elif block == "TREES":
            if head == "TRANSLATE":
                body_tr = st[st.upper().find("TRANSLATE") + 9:]
                for pair in body_tr.split(","):
                    parts = pair.strip().split(None, 1)
                    if len(parts) != 2:
                        continue
                    # the value may be a quoted label with spaces
                    vname, _ = _split_name_chunks(parts[1])
                    if vname:
                        translate[parts[0]] = vname
            elif head in ("TREE", "UTREE"):
                eq = st.find("=")
                if eq < 0:
                    continue
                name_part = st[:eq].split()
                name = name_part[1] if len(name_part) > 1 else (
                    f"tree{len(trees)}"
                )
                tree = parse_newick(st[eq + 1:] + ";")
                if translate:
                    names = [
                        translate.get(n, n) if i < tree.n_leaves else n
                        for i, n in enumerate(tree.names)
                    ]
                    tree = dataclasses.replace(tree, names=tuple(names))
                trees[name] = tree
    return {"alignment": alignment, "trees": trees}


# ---------------------------------------------------------------------------
# Site-pattern compression
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CompressedAlignment:
    """Unique site patterns + weights.

    ``partials``: (n_taxa, n_patterns, n_states) leaf partial rows.
    ``weights``:  (n_patterns,) pattern multiplicities (float for device use).
    ``site_to_pattern``: (n_sites,) index mapping for sitewise expansion.
    """

    names: Tuple[str, ...]
    partials: np.ndarray
    weights: np.ndarray
    site_to_pattern: np.ndarray

    @property
    def n_patterns(self) -> int:
        return self.partials.shape[1]

    @property
    def n_sites(self) -> int:
        return int(self.site_to_pattern.shape[0])


def compress_patterns(
    sequences: Dict[str, str], alphabet="dna", dtype=np.float64
) -> CompressedAlignment:
    """Collapse identical alignment columns into unique patterns + weights.

    Compression happens on the raw character matrix (cheap, exact) before
    encoding to partials. Patterns come out in ``np.unique`` order.
    """
    from phylo_utils_tpu_torch.alphabets import get_alphabet, _charmap_table

    if getattr(alphabet, "name", alphabet) == "codon":
        raise NotImplementedError(
            "codon alignments are not ported yet (ROADMAP A14)"
        )
    names = list(sequences.keys())
    alpha = get_alphabet(alphabet)
    chars = np.array(
        [np.frombuffer(sequences[n].upper().encode("ascii"), dtype=np.uint8) for n in names]
    )  # (taxa, sites)
    uniq_cols, site_to_pattern, counts = np.unique(
        chars.T, axis=0, return_inverse=True, return_counts=True
    )
    uniq_cols = uniq_cols.T  # (taxa, patterns)
    table = _charmap_table(alpha, dtype)
    partials = table[uniq_cols]  # (taxa, patterns, states)
    return CompressedAlignment(
        names=tuple(names),
        partials=partials,
        weights=counts.astype(dtype),
        site_to_pattern=site_to_pattern.astype(np.int32).ravel(),
    )
