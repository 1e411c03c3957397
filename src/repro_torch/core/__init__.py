"""The paper's contribution: speculative decoding for SMILES generators by
copying query substrings into the target, ported to PyTorch.

  drafting     — source-copy draft extraction (§2.1, Fig. 2)
  session      — the fixed-slot step all four modes share
  speculative  — speculative greedy decoding (accuracy-neutral, Table 2)
  spec_beam    — speculative beam search, Algorithm 1 / Appendix B
  multidraft   — every draft verified in one row per sequence (beyond the
                 paper; decoder-only models)
  greedy/beam  — the standard baselines the paper compares against
  handles      — the decoder contract (seq2seq MT, decoder-only LM)
"""

from repro_torch.core.beam import batched_beam_search, beam_search
from repro_torch.core.drafting import (batch_drafts, extract_drafts,
                                      prompt_lookup_drafts)
from repro_torch.core.greedy import greedy_decode
from repro_torch.core.handles import (DecoderHandle, seq2seq_handle,
                                      transformer_handle)
from repro_torch.core.multidraft import (build_local_mask,
                                         multidraft_speculative_decode)
from repro_torch.core.session import (SessionSpec, SessionState, init_state,
                                      run_session, session_step)
from repro_torch.core.spec_beam import (batched_speculative_beam_search,
                                        speculative_beam_search)
from repro_torch.core.speculative import speculative_greedy_decode

__all__ = [
    "batch_drafts", "extract_drafts", "prompt_lookup_drafts",
    "DecoderHandle", "seq2seq_handle", "transformer_handle",
    "SessionSpec", "SessionState", "init_state", "session_step",
    "run_session", "greedy_decode", "speculative_greedy_decode",
    "beam_search", "batched_beam_search", "speculative_beam_search",
    "batched_speculative_beam_search", "build_local_mask",
    "multidraft_speculative_decode",
]
