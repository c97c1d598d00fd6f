"""Hop aggregation: the first confident hop's answer."""

from __future__ import annotations

from typing import Tuple

import torch


def select_aggregate(scores: torch.Tensor, do_pred: torch.Tensor, *,
                     force_final: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-hop-that-fired selection (reference
    Ours_SS/LstmAttCtrlGradNoiseDontSelect.lua:504-515 train, :683-697 test).

    scores [H, B, A]; do_pred [H, B] sigmoid probabilities.  Returns
    (select_pred [B, A], gates [H, B]); ``gates[h]`` is 1 where hop h is the
    first confident hop.  With ``force_final`` the last hop always fires."""
    fired = (do_pred > 0.5).to(scores.dtype)
    if force_final:
        fired = fired.clone()
        fired[-1] = 1.0
    did_pred = torch.clamp(torch.cumsum(fired, dim=0), 0.0, 1.0)
    prev_did = torch.cat([torch.zeros_like(did_pred[:1]), did_pred[:-1]])
    gates = torch.clamp(fired - prev_did, 0.0, 1.0)
    select_pred = torch.einsum("hba,hb->ba", scores, gates)
    return select_pred, gates
