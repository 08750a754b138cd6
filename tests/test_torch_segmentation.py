"""cse_tpu_torch.ops.segmentation / buckets against the cse_tpu originals."""

import numpy as np
import pytest
import torch

from cse_tpu.ops import buckets as jbuckets
from cse_tpu.ops import segmentation as jseg
from cse_tpu_torch.ops import buckets, segmentation

torch.set_num_threads(1)

# gap = K - (P + L % K) % K lies in [1, K]: L=15 gives the largest (gap=K=10),
# L=12 an odd gap (3), L=18 gap=7, L=1 a single short chunk.
LENGTHS = [1, 12, 15, 18, 23, 40, 97]


@pytest.mark.parametrize("L", LENGTHS)
def test_segment_shapes_match(L):
    for K in (10, 11, 250):
        assert segmentation.segment_shapes(L, K) == jseg.segment_shapes(L, K)


@pytest.mark.parametrize("L", LENGTHS)
def test_segment_and_overlap_add_match(rng, L):
    K = 10
    x = rng.standard_normal((2, L, 3)).astype(np.float32)
    want, gap_j = jseg.segment(x, K)
    got, gap = segmentation.segment(torch.from_numpy(x), K)
    assert gap == gap_j and 1 <= gap <= K
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y = rng.standard_normal(tuple(got.shape)).astype(np.float32)
    np.testing.assert_allclose(
        segmentation.overlap_add(torch.from_numpy(y), gap).numpy(),
        np.asarray(jseg.overlap_add(y, gap)), rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("T", [16000, 32000, 64000, 128000, 240000])
def test_aligned_bucket_matches(T):
    assert buckets.aligned_bucket(T) == jbuckets.aligned_bucket(T)
    assert buckets.inter_len(T) == jbuckets.inter_len(T)
    assert buckets.frames_for_samples(T) == jbuckets.frames_for_samples(T)


def test_main_path_shapes():
    """The serving main path's shapes: T=aligned_bucket(128000) gives intra
    sequences of K+1=251 and inter sequences of S+1=127 tokens."""
    T = buckets.aligned_bucket(128000)
    L = buckets.frames_for_samples(T)
    gap, S = segmentation.segment_shapes(L, 250)
    assert (T, L, S + 1) == (125000, 15624, 127)
    assert 16 * S == 2016 and 16 * 250 == 4000
