"""The port's layout diagnosis (rau_vqa_tpu_torch/utils/layout_diag.py and
the ``layout=`` argument of utils/torch_convert.py) against the JAX
package's: the 7 cases of tests/test_layout_diag.py, each run through both
packages on the same params (the JAX init, the port's tree its tensors),
and ``layout_report``'s text equal to the JAX package's at the paper's
dims.  Exact equality: the flats are the same float32 values moved."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rau_vqa_tpu.config import ModelConfig as JModelConfig
from rau_vqa_tpu.config import get_preset as jax_get_preset
from rau_vqa_tpu.models.rau import init_params
from rau_vqa_tpu.utils import layout_diag as jld
from rau_vqa_tpu.utils import torch_convert as jtc
from rau_vqa_tpu_torch.config import ModelConfig, get_preset
from rau_vqa_tpu_torch.convert import map_tree, tree_leaves
from rau_vqa_tpu_torch.utils import layout_diag as ld
from rau_vqa_tpu_torch.utils.torch_convert import GROUP_LAYOUTS, flat_to_group, group_to_flat

DIMS = dict(vocab_size=50, answer_size=17, seq_len=9, embed_dim=8, rnn_size=16,
            rnn_layers=2, cnn_dim=12, cnn_w=3, cnn_h=2, multfeat_dim=16,
            attfeat_dim=8, att_rnn_size=16, att_rnn_layers=1, n_hops=3)
JCFG, CFG = JModelConfig(**DIMS), ModelConfig(**DIMS)


def _params():
    """(the JAX tree as numpy, the port's tree of the same values)."""
    p = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(7), JCFG))
    return p, map_tree(lambda a: torch.from_numpy(np.array(a)), p)


def _names(layout):
    return [e[0] for e in layout]


def _scrambled_mult_layout(layouts):
    """Swap the two ambiguous module pairs: att_q <-> att_i and h_proj <->
    merge (the mismatches size segmentation cannot see)."""
    layout = list(layouts["mult"](CFG if layouts is GROUP_LAYOUTS else JCFG))
    pos = {e[0]: i for i, e in enumerate(layout)}
    for a, b in (("att_q", "att_i"), ("h_proj", "merge")):
        for leaf in ("w", "b"):
            i, j = pos[("mult", a, leaf)], pos[("mult", b, leaf)]
            layout[i], layout[j] = layout[j], layout[i]
    return layout


def test_ambiguity_report_names_confusable_entries():
    rep = ld.layout_report(CFG)
    assert rep == jld.layout_report(JCFG)
    assert "AMBIGUOUS" in rep and "att_q" in rep and "att_i" in rep
    assert "[embed] 1 tensors" in rep
    for g in ("embed", "rnn", "mult"):
        assert ld.ambiguity_classes(CFG, g) == jld.ambiguity_classes(JCFG, g)


@pytest.mark.parametrize("name", ["ours_ss", "ours_ms", "ours_resnet", "ours_vit"])
def test_layout_report_equals_the_jax_one_at_the_paper_dims(name):
    jcfg = dataclasses.replace(jax_get_preset(name).model, vocab_size=12605)
    cfg = dataclasses.replace(get_preset(name), vocab_size=12605)
    assert ld.layout_report(cfg) == jld.layout_report(jcfg)


def test_content_alignment_recovers_scrambled_order():
    jp, tp = _params()
    scrambled = _scrambled_mult_layout(GROUP_LAYOUTS)
    assert _names(scrambled) == _names(_scrambled_mult_layout(jtc.GROUP_LAYOUTS))
    flat = group_to_flat(tp["mult"], CFG, "mult", layout=scrambled).astype(np.float32)
    jflat = jtc.group_to_flat(jp["mult"], JCFG, "mult",
                              layout=_scrambled_mult_layout(jtc.GROUP_LAYOUTS))
    assert np.array_equal(flat, jflat.astype(np.float32))

    naive = flat_to_group(flat, CFG, "mult")
    assert not torch.allclose(naive["att_q"]["w"], tp["mult"]["att_q"]["w"])

    recovered = ld.align_flat_by_content(flat, CFG, "mult", tp["mult"])
    assert _names(recovered) == _names(scrambled)
    # a tree of numpy arrays (the JAX package's) is as good a reference
    assert _names(ld.align_flat_by_content(flat, CFG, "mult", jp["mult"])) == \
        _names(scrambled)
    assert _names(jld.align_flat_by_content(flat, JCFG, "mult", jp["mult"])) == \
        _names(recovered)
    diff = ld.layout_diff(CFG, "mult", recovered)
    assert diff == jld.layout_diff(JCFG, "mult", jld.align_flat_by_content(
        flat, JCFG, "mult", jp["mult"]))
    assert diff and any("att_q" in d for d in diff)

    repaired = flat_to_group(flat, CFG, "mult", layout=recovered)
    same = []
    map_tree(lambda a, b: same.append(torch.equal(a, b)), tp["mult"], repaired)
    assert same and all(same)


def test_content_alignment_identity_when_order_matches():
    jp, tp = _params()
    for g in ("embed", "rnn", "mult"):
        flat = group_to_flat(tp[g], CFG, g).astype(np.float32)
        assert np.array_equal(flat, jtc.group_to_flat(jp[g], JCFG, g).astype(np.float32))
        recovered = ld.align_flat_by_content(flat, CFG, g, tp[g])
        assert _names(recovered) == _names(GROUP_LAYOUTS[g](CFG))
        assert ld.layout_diff(CFG, g, recovered) == []


def test_content_alignment_rejects_garbage():
    _, tp = _params()
    flat = np.random.RandomState(0).randn(
        sum(int(np.prod(s)) for _, s, _ in GROUP_LAYOUTS["mult"](CFG))).astype(np.float32)
    with pytest.raises(ValueError, match="contents disagree") as e:
        ld.align_flat_by_content(flat, CFG, "mult", tp["mult"])
    with pytest.raises(ValueError) as je:
        jld.align_flat_by_content(flat, JCFG, "mult", _params()[0]["mult"])
    assert str(e.value) == str(je.value)


def test_candidate_layouts_cover_module_swaps():
    cands = ld.candidate_layouts(CFG, "mult")
    assert [_names(c) for c in cands] == \
        [_names(c) for c in jld.candidate_layouts(JCFG, "mult")]
    assert cands[0] == GROUP_LAYOUTS["mult"](CFG)
    scrambled = _scrambled_mult_layout(GROUP_LAYOUTS)
    assert any(_names(c) == _names(scrambled) for c in cands)
    assert len(ld.candidate_layouts(CFG, "embed")) == 1


def test_candidate_layouts_cover_i2h_h2h_swap():
    rnn_cands = ld.candidate_layouts(CFG, "rnn")
    assert [_names(c) for c in rnn_cands] == \
        [_names(c) for c in jld.candidate_layouts(JCFG, "rnn")]
    ours = GROUP_LAYOUTS["rnn"](CFG)
    assert rnn_cands[0] == ours
    prefix = ("rnn", "layers", str(CFG.rnn_layers - 1))
    idx = next(i for i, e in enumerate(ours) if e[0][:3] == prefix)
    others = [e for e in ours if e[0][:3] != prefix]
    wi, bi, wh, bh = [e for e in ours if e[0][:3] == prefix]
    swapped = others[:idx] + [wh, bh, wi, bi] + others[idx:]
    assert any(_names(c) == _names(swapped) for c in rnn_cands)


def test_search_recovers_order_from_score_alone():
    """No trusted tree, only a scoring oracle (a stand-in for agreement with
    the released result JSONs): both packages pick the same order."""
    jp, tp = _params()
    scrambled = _scrambled_mult_layout(GROUP_LAYOUTS)
    flat = group_to_flat(tp["mult"], CFG, "mult", layout=scrambled).astype(np.float32)

    def score(subtree) -> float:
        return -float(sum(tree_leaves(map_tree(lambda a, b: (a - b).abs().sum(),
                                               tp["mult"], subtree))))

    def jscore(subtree) -> float:
        return -float(sum(np.abs(a - b).sum() for a, b in
                          zip(jax.tree.leaves(subtree), jax.tree.leaves(jp["mult"]))))

    best, best_score = ld.search_layout_by_score(flat, CFG, "mult", score)
    jbest, jbest_score = jld.search_layout_by_score(flat, JCFG, "mult", jscore)
    assert best_score == 0.0 == jbest_score
    assert _names(best) == _names(scrambled) == _names(jbest)
