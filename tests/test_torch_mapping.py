"""Port parity for the label tables of ``segfusion_tpu_torch.utils.mapping``
against ``segfusion_tpu.utils.mapping``: each palette and id mapping, the
class-name tables and the ScanNet raw-id lookup from a tsv must be equal
(tolerance 0, dtypes included)."""

import numpy as np
import pytest

from segfusion_tpu.utils import mapping as j_mapping
from segfusion_tpu_torch.utils import mapping


@pytest.mark.parametrize("name", [
    "replica_color_palette", "scannet_color_palette", "nyu40_color_palette",
    "nyu20_color_palette", "scannet_main_ids", "nyu40_to_nyu20_map",
    "get_mapping"])
def test_table_functions_match_jax(name):
    got, want = getattr(mapping, name)(), getattr(j_mapping, name)()
    assert type(got) is type(want)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("name", [
    "REPLICA_CLASSES", "NYU40_CLASSES", "NYU20_CLASSES", "_SCANNET_PALETTE",
    "_REPLICA_PALETTE"])
def test_constant_tables_match_jax(name):
    got, want = getattr(mapping, name), getattr(j_mapping, name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("tsv", ["file", "missing", "none"])
def test_scannet_to_nyu40_map_matches_jax(tmp_path, tsv):
    """From a tsv with unmapped, malformed and out-of-range rows, from a
    path that does not exist, and from none: equal lookups."""
    path = None
    if tsv != "none":
        path = str(tmp_path / "labels.tsv")
    if tsv == "file":
        rng = np.random.RandomState(0)
        with open(path, "w") as f:
            f.write("id\traw_category\tcategory\tnyu40id\n")
            for raw in rng.choice(1500, 300, replace=False):
                f.write(f"{raw}\tc{raw}\tc\t{rng.randint(0, 41)}\n")
            f.write("12\tbad\tc\t\n-3\tneg\tc\t4\n")
    for kw in ({}, {"max_raw_id": 60}):
        got = mapping.scannet_to_nyu40_map(path, **kw)
        want = j_mapping.scannet_to_nyu40_map(path, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
