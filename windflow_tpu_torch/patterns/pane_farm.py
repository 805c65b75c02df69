"""Pane_Farm: pane decomposition of sliding windows — a two-stage pipeline
(reference pane_farm.hpp).

Stage 1 (PLQ, pane-level query) computes per-pane partials over *tumbling*
panes of length ``gcd(win, slide)`` (pane_farm.hpp:148-162); its results are
renumbered to a dense per-key pane index (the PLQ role renumbering,
win_seq.hpp:401-404).  Stage 2 (WLQ, window-level query) combines
``win/pane`` consecutive pane-results per window as a *count-based* window
of length ``win/pane`` sliding by ``slide/pane`` over the pane stream
(pane_farm.hpp:168-175).  Either stage can be a Win_Seq (degree 1) or an
ordered Win_Farm (degree > 1), and each stage independently accepts a
non-incremental or incremental user function (the reference's 4 constructor
families, pane_farm.hpp:105-418).

This is the streaming analog of a two-level blockwise reduction — on the
TPU it maps onto segmented partial reductions per core merged over ICI
(SURVEY.md §5 long-context note).
"""

from __future__ import annotations

from ..core.windows import PatternConfig, Role, WindowSpec, WinType
from .win_farm import WinFarm
from .win_seq import WinSeq


class PaneFarm:
    """Composite two-stage pattern; wired by `instantiate` (used via
    add_farm / MultiPipe)."""

    def __init__(self, plq_func, wlq_func, win_len, slide_len,
                 win_type=WinType.CB, plq_degree=1, wlq_degree=1,
                 name="pane_farm", plq_incremental=None, wlq_incremental=None,
                 plq_result_fields=None, wlq_result_fields=None, ordered=True,
                 config: PatternConfig = None, opt_level: int = 0):
        if win_len <= slide_len:
            raise ValueError(
                "Pane_Farm requires sliding windows (slide < win), "
                "pane_farm.hpp:143")
        # keep construction parameters so nesting farms can replicate this
        # pattern with overridden slide/config (win_farm.hpp:376-389)
        self._proto = dict(
            plq_func=plq_func, wlq_func=wlq_func, win_len=win_len,
            slide_len=slide_len, win_type=win_type, plq_degree=plq_degree,
            wlq_degree=wlq_degree, plq_incremental=plq_incremental,
            wlq_incremental=wlq_incremental,
            plq_result_fields=plq_result_fields,
            wlq_result_fields=wlq_result_fields, opt_level=opt_level)
        self.opt_level = opt_level
        self.spec = WindowSpec(win_len, slide_len, win_type)
        self.pane_len = self.spec.pane_len()
        self.win_type = win_type
        self.plq_degree = plq_degree
        self.wlq_degree = wlq_degree
        self.name = name
        self.ordered = ordered
        self.config = config or PatternConfig.plain(slide_len)
        from .basic import user_call_site
        #: construction-site anchor for check/ diagnostics (WF103)
        self.anchor = user_call_site()
        cfg = self.config
        pane = self.pane_len
        # --- PLQ stage: tumbling panes, role PLQ (pane_farm.hpp:152-162) ---
        self.plq = self._make_stage(
            "plq", plq_func, pane, pane, win_type, plq_degree,
            name=f"{name}_plq", incremental=plq_incremental,
            result_fields=plq_result_fields, ordered=True, role=Role.PLQ)
        # --- WLQ stage: CB window over the dense pane stream
        # --- (pane_farm.hpp:166-175) ---
        self.wlq = self._make_stage(
            "wlq", wlq_func, win_len // pane, slide_len // pane, WinType.CB,
            wlq_degree, name=f"{name}_wlq", incremental=wlq_incremental,
            result_fields=wlq_result_fields, ordered=ordered, role=Role.WLQ)

    def _make_stage(self, which, func, win, slide, wt, degree, name,
                    incremental, result_fields, ordered, role):
        """Build one stage as Win_Seq (degree 1) or ordered Win_Farm —
        overridable for device placement (Pane_Farm_GPU's 4 constructor
        families, pane_farm_gpu.hpp:176-480, become a per-stage override)."""
        cfg = self.config
        if degree > 1:
            return WinFarm(func, win, slide, wt, pardegree=degree, name=name,
                           incremental=incremental,
                           result_fields=result_fields, ordered=ordered,
                           config=cfg, role=role)
        seq_cfg = PatternConfig(cfg.id_inner, cfg.n_inner, cfg.slide_inner,
                                0, 1, slide)
        return WinSeq(func, win, slide, wt, name=name,
                      incremental=incremental, result_fields=result_fields,
                      config=seq_cfg, role=role)

    @property
    def result_schema(self):
        return self.wlq.result_schema

    def instantiate(self, df, upstreams):
        from ..runtime.farm import add_farm, fuse_two_stage
        if self.opt_level >= 1:
            # optimize_PaneFarm (pane_farm.hpp:426-466): LEVEL1 fuses the
            # stage boundary into one thread, LEVEL2 removes the PLQ
            # collector and merges at OrderingCore-fronted WLQ workers
            return fuse_two_stage(df, self.plq, self.wlq, upstreams,
                                  self.opt_level)
        tails = add_farm(df, self.plq, upstreams)
        return add_farm(df, self.wlq, tails)

    def clone_with(self, name, slide_len=None, config=None, ordered=False):
        """Replicate this pattern as a nested-farm worker (the reference
        rebuilds the Pane_Farm from its stored functions with a private
        slide and worker PatternConfig, win_farm.hpp:376-389)."""
        kw = dict(self._proto)
        if slide_len is not None:
            kw["slide_len"] = slide_len
        return PaneFarm(name=name, config=config, ordered=ordered, **kw)
