"""The yardstick's arithmetic against counts made by hand."""
import pytest

from portbench import costs


def test_histogram_cost_is_the_formula():
    G, n, d, S, m, B = 3, 100, 4, 5, 2, 32
    c = costs.histogram_cost(G, n, d, S, m, B)
    # int32 bins, f32 stats, int32 positions read once; f32 output once
    assert c["bytes"] == 4 * (n * d + G * n * S + G * n + G * m * S * d * B)
    assert c["adds"] == G * n * d * S
    # per instance: ceil(n/16) k-steps x d x ceil(B/16) x ceil(S/8) mma
    assert c["mma"] == G * 7 * d * 2 * 1
    assert c["mma_flop"] == 4096 * c["mma"]
    two = costs.histogram_cost(G, n, d, S, m, B, Gbins=2)
    assert two["bytes"] - c["bytes"] == 4 * n * d


def test_histogram_bound_takes_the_larger_of_bytes_and_adds():
    shape = (16, 200_000, 28, 5, 8, 32)
    c = costs.histogram_cost(*shape)
    want = max(c["bytes"] / 3.35e12, c["adds"] / 67e12)
    assert costs.histogram_bound_s(shape) == pytest.approx(want)
    # the capture shape is bound by its bytes: 0.0303 ms
    assert costs.histogram_bound_s(shape) == pytest.approx(3.03e-5, rel=0.01)


@pytest.mark.parametrize("family,hyper,want", [
    ("DecisionTreeClassifier", {"maxDepth": 3.0}, 10 * 4 * 5 * 3),
    ("RandomForestClassifier", {"maxDepth": 5.0, "numTrees": 20.0},
     10 * 4 * 5 * 5 * 20),
    ("GBTClassifier", {"maxDepth": 5.0, "maxIter": 20.0}, 10 * 4 * 3 * 5 * 20),
    ("XGBoostClassifier", {"maxDepth": 6.0, "maxIter": 24.0},
     10 * 4 * 3 * 6 * 24),
    # the hyper asks deeper than the cap: the cap's levels
    ("GBTClassifier", {"maxDepth": 9.0, "maxIter": 1.0}, 10 * 4 * 3 * 5),
])
def test_tree_flops_by_hand(family, hyper, want):
    assert costs.tree_flops(family, hyper, 10, 4) == want


def test_linear_flops_by_hand():
    n, d = 10, 3
    p = d + 1
    mv = 2 * n * p
    newton = 15 * (2 * mv + 2 * n * p * p)
    assert costs.linear_flops("LogisticRegression",
                              {"elasticNetParam": 0.0}, n, d) == newton
    assert costs.linear_flops("LogisticRegression",
                              {"elasticNetParam": 0.5}, n, d) == \
        newton + 13 * 2 * mv + 200 * 2 * mv
    assert costs.linear_flops("LinearSVC", {}, n, d) == 13 * 2 * mv + 200 * 2 * mv
    assert costs.linear_flops("NaiveBayes", {}, n, d) == 2 * 2 * n * 2 * d


def test_fit_terms_count_every_fold_and_the_refit():
    val = [{"family": "DecisionTreeClassifier",
            "grid": [{"maxDepth": 3.0}, {"maxDepth": 5.0}]},
           {"family": "NaiveBayes", "grid": [{"smoothing": 1.0}]}]
    terms = costs.fit_terms(val, "DecisionTreeClassifier", {"maxDepth": 5.0},
                            n_train=30, d=4, folds=3)
    n_fold = 20
    trees = [f for f, t in terms if t == "bf16"]
    assert sorted(trees) == sorted(
        [n_fold * 4 * 5 * 3] * 3 + [n_fold * 4 * 5 * 5] * 3
        + [30 * 4 * 5 * 5])
    f32 = sum(f for f, t in terms if t == "f32")
    assert f32 == 3 * (costs.linear_flops("NaiveBayes", {}, n_fold, 4)
                       + 2 * 10 * 5)
    assert costs.mfu_seconds([(989e12, "bf16"), (67e12, "f32")]) == 2.0
