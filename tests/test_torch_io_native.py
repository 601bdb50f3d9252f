"""Port parity, the host data path: the port's native (C++) pattern
compressor and FASTA reader (``phylo_utils_tpu_torch.native``,
``tests/test_native.py``'s cases), the writers ``write_fasta``,
``write_phylip`` and ``write_nexus``, ``parse_newick_forest`` and
``load_compressed``, against the JAX package's and the Python/numpy
paths.

Tolerances: none. The writers' text equals the JAX package's character for
character; ``load_compressed`` equals the JAX package's array for array
(names, partials, weights, site_to_pattern: both give patterns in order of
first occurrence); the native reader and compressor equal numpy's.
"""
import numpy as np
import pytest

from phylo_utils_tpu import io as jio
from phylo_utils_tpu_torch import io as tio
from phylo_utils_tpu_torch import native

from torch_threads import one_thread  # noqa: F401


def test_compress_chars_matches_numpy_unique():
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("acgtACGT-N?ry"), size=307))
            for _ in range(13)]
    chars, uniq, s2p, counts = native.compress_chars_native(seqs)
    ref = np.array(
        [np.frombuffer(s.upper().encode(), dtype=np.uint8) for s in seqs]
    )
    assert (chars == ref).all()
    assert (uniq[:, s2p] == ref).all()          # reconstruction
    assert counts.sum() == 307
    assert uniq.shape[1] == np.unique(ref.T, axis=0).shape[0]


def test_compress_rejects_ragged():
    with pytest.raises(ValueError):
        native.compress_chars_native(["ACGT", "ACG"])


def test_fasta_matrix_native(tmp_path):
    fa = tmp_path / "x.fa"
    fa.write_text(
        ">seq_one some description\nacgtAC\nGT\n\n>seq_two\nACGTTGCA\n"
        ">seq_three\nAG-N?CGA\n"
    )
    names, matrix = native.read_fasta_matrix_native(str(fa))
    assert names == ["seq_one", "seq_two", "seq_three"]
    got = {n: bytes(matrix[i]).decode() for i, n in enumerate(names)}
    want = {k: v.upper() for k, v in tio.read_fasta(str(fa)).items()}
    assert got == want


def test_fasta_matrix_native_ragged_raises(tmp_path):
    fa = tmp_path / "bad.fa"
    fa.write_text(">a\nACGT\n>b\nACG\n")
    with pytest.raises(ValueError):
        native.read_fasta_matrix_native(str(fa))


def _alignment(n_taxa=9, n_sites=400, chars="AC", seed=1):
    """Low-cardinality columns, so compression collapses them."""
    rng = np.random.default_rng(seed)
    return {f"t{i}": "".join(rng.choice(list(chars), size=n_sites))
            for i in range(n_taxa)}


def test_load_compressed_equals_python_path(tmp_path):
    fa = tmp_path / "big.fa"
    tio.write_fasta(_alignment(), path=str(fa))
    ca_native = tio.load_compressed(str(fa))
    ca_python = tio.compress_patterns(tio.read_fasta(str(fa)))
    assert isinstance(ca_native, tio.CompressedAlignment)
    assert ca_native.names == ca_python.names
    assert ca_native.n_patterns == ca_python.n_patterns < 400
    np.testing.assert_array_equal(
        ca_native.partials[:, ca_native.site_to_pattern],
        ca_python.partials[:, ca_python.site_to_pattern])
    assert ca_native.weights.sum() == ca_python.weights.sum() == 400


@pytest.mark.parametrize("fmt", ["fasta", "phylip"])
def test_load_compressed_equals_jax(tmp_path, fmt):
    aln = _alignment(n_taxa=7, n_sites=300, chars="ACGT-Nr", seed=3)
    path = str(tmp_path / f"x.{fmt}")
    getattr(tio, f"write_{fmt}")(aln, path=path)
    got = tio.load_compressed(path)
    want = jio.load_compressed(path)
    assert got.names == want.names
    for field in ("partials", "weights", "site_to_pattern"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


def test_writers_text_equals_jax(tmp_path):
    aln = {"a": "ACGTACGTGG" * 9, "bee tree": "AC-TNCGTRG" * 9,
           "c'x": "acgtacgtgg" * 9}
    assert tio.write_fasta(aln) == jio.write_fasta(aln)
    assert tio.write_fasta(aln, width=7) == jio.write_fasta(aln, width=7)
    assert tio.write_phylip(aln) == jio.write_phylip(aln)
    newick = "((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);"
    trees_t = {"one": tio.parse_newick(newick), "two two":
               tio.parse_newick("(x:1,(y:2,z:3):0.5);")}
    trees_j = {k: jio.parse_newick(tio.write_newick(v))
               for k, v in trees_t.items()}
    for kw_t, kw_j in (({"alignment": aln}, {"alignment": aln}),
                       ({"trees": trees_t}, {"trees": trees_j}),
                       ({"alignment": aln, "trees": trees_t,
                         "datatype": "PROTEIN"},
                        {"alignment": aln, "trees": trees_j,
                         "datatype": "PROTEIN"})):
        assert tio.write_nexus(**kw_t) == jio.write_nexus(**kw_j)
    path = tmp_path / "x.nex"
    round_trip = {"one": trees_t["one"], "t_2": trees_t["two two"]}
    text = tio.write_nexus(aln, round_trip, path=str(path))
    assert path.read_text() == text
    back = tio.read_nexus(str(path))
    assert back["alignment"] == aln
    assert set(back["trees"]) == set(round_trip)
    # a quoted tree name with a space does not round-trip in either
    # package: read_nexus cuts it at the space (ROADMAP C)
    text = tio.write_nexus(trees=trees_t)
    assert set(tio.read_nexus(text)["trees"]) == \
        set(jio.read_nexus(text)["trees"]) == {"one", "'two"}
    with pytest.raises(ValueError):
        tio.write_phylip({"a": "AC", "b": "A"})
    with pytest.raises(ValueError):
        tio.write_phylip({})


def test_parse_newick_forest_equals_jax(tmp_path):
    text = ("((a:0.1,b:0.2):0.05,(c:0.3,d:0.15):0.07);\n"
            "(x:1,(y:2,z:3)n1:0.5);  \n((p,q),r);\n")
    path = tmp_path / "forest.nwk"
    path.write_text(text)
    for src in (text, str(path)):
        got = tio.parse_newick_forest(src)
        want = jio.parse_newick_forest(src)
        assert len(got) == len(want) == 3
        for t, j in zip(got, want):
            assert t.names == j.names and t.children == j.children
            np.testing.assert_array_equal(t.parent, j.parent)
            np.testing.assert_array_equal(t.lengths, j.lengths)
