"""The fabric: per-edge links and per-node mailboxes between ADMM rounds
(twin of ``repro/net/fabric.py``).

Each node publishes one message bundle per round, its masked decision
vectors ``r * active``, and each directed edge applies its
``LinkPolicy`` in flight: token-bucket bandwidth at the sender, i.i.d.
in-transit drops, a delay in rounds, a wire-format quantization.
Receivers keep the last value delivered per (neighbor, task) in a
mailbox; the consensus neighbor sums of Prop. 1 read the mailbox, never
the live neighbor state.

Two modes, chosen when the fabric is built:

- ``buffer``: the identity fast path.  When every link is a perfect
  synchronous float32 wire and link availability never varies, every
  receiver holds the same copies, so the fabric keeps one shared
  (V, T, D) buffer of last-published values and reduces it with the
  expression of ``core._default_nbr_reduce``.  That is what makes the
  identity configuration bitwise the ``vmap`` backend
  (tests/test_torch_net.py).
- ``mailbox``: per-receiver (V, V, T, D) mailboxes, a ring of published
  payloads for delays, per-edge send decisions (availability x
  activation x bandwidth x drop).  The drops come from the reference's
  counter-based stream keyed on the absolute round
  (``repro_torch.net.prng``), so a run loses the same messages as the
  reference's however it is split across calls.

All state lives in an explicit ``FabricState`` of tensors on the
fabric's device; the ``Fabric`` is static configuration.  No method
changes a state in place: each returns a new one, so a caller may keep
an old state (a split run, a snapshot).  Counters accumulate in units of
per-task wire vectors, so per-edge bytes are ``msgs_sent * bytes_m``;
``repro_torch.net.meter`` turns them into reports.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.net import policies as pol
from repro_torch.net import prng


class FabricState(NamedTuple):
    """Everything that evolves round to round.  In buffer mode the
    delay and credit machinery is inert but kept, so both modes carry
    the same fields."""
    mailbox: torch.Tensor         # (V,T,D) buffer mode | (V,V,T,D) mailbox
    pub_hist: torch.Tensor        # (L, V, T, D) published-payload ring
    ok_hist: torch.Tensor         # (L, V, V) bool send-success ring
    tc_hist: torch.Tensor         # (L, V) task-vectors per send, per slot
    credit: torch.Tensor          # (V, V) token-bucket credit [v, u]
    round: torch.Tensor           # () int32 absolute round counter
    msgs_sent: torch.Tensor       # (V, V) f32 task-vectors charged [v, u]
    msgs_delivered: torch.Tensor  # (V, V) f32 task-vectors delivered
    warmfill_msgs: torch.Tensor   # () f32 bootstrap deliveries
    silence: torch.Tensor         # (V, V) int32 rounds since last delivery
    ef_resid: torch.Tensor        # (V,V,T,D) error-feedback residuals, or
    #                               (1,1,1,1) zeros when EF is off


class Fabric:
    """Static link-layer configuration over one consensus graph.

    Edge matrices are indexed ``[v, u]`` = (receiver, sender), as the
    dense-adjacency reduce ``einsum("vu,utd->vtd", adj, x)``.  ``adj``
    is a numpy array or a tensor; the fabric lives on the tensor's
    device, else on ``device`` (``None`` means ``"cuda"``).
    """

    def __init__(self, adj, dim: int, net: pol.NetConfig, *,
                 force_mailbox: bool = False, device=None):
        if isinstance(adj, torch.Tensor):
            dev = adj.device
            adj = adj.detach().cpu().numpy()
        else:
            dev = device_lib.resolve(device)
        adj = np.asarray(adj, bool)
        V = adj.shape[0]
        self.V, self.D = V, int(dim)
        self.device = dev
        self.net = net
        self.adj_np = adj
        self.adj = torch.as_tensor(adj, device=dev)
        self.adjf = self.adj.to(torch.float32)
        self.mode = ("buffer" if net.is_identity and not force_mailbox
                     else "mailbox")

        delay = np.zeros((V, V), np.int32)
        drop = np.zeros((V, V), np.float32)
        qcode = np.zeros((V, V), np.int32)
        bw = np.full((V, V), np.inf, np.float32)
        bpm = np.zeros((V, V), np.float32)
        for v in range(V):
            for u in range(V):
                if not adj[v, u]:
                    continue
                p = net.edge_policy(u, v)          # directed link u -> v
                delay[v, u] = p.delay
                drop[v, u] = p.drop
                qcode[v, u] = pol.QUANT_CODES[p.quant]
                if p.bandwidth is not None:
                    bw[v, u] = p.bandwidth
                bpm[v, u] = pol.bytes_per_message(p.quant, self.D)
        on = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        #: the drop matrix stays on the host: the drop masks are drawn
        #: there, once per call of ``run_async``
        self.drop_np = drop
        self.delay_m = on(delay)
        self.drop_m = on(drop)
        self.qcode_m = on(qcode)
        self.bw_m = on(bw)
        self.bytes_m = on(bpm * adj)
        self.hist_len = int(delay.max()) + 1
        self.seed = int(net.seed)
        self._codes = sorted({int(c) for c in np.unique(qcode[adj])}
                             - {0}) if adj.any() else []
        self._code_sel = {c: (self.qcode_m == c)[:, :, None, None]
                          for c in self._codes}
        # gather indices of the delay ring, made once
        vv, uu = np.indices((V, V))
        self._vv, self._uu = on(vv), on(uu)
        self.stale_limit = net.stale_limit
        # error feedback compensates the sender's quantizer at publish
        # time, so its values are per edge; the delay ring stores one raw
        # payload per sender and quantizes at delivery
        self.error_feedback = bool(net.error_feedback)
        if self.error_feedback and self.hist_len > 1:
            raise ValueError(
                "error_feedback requires zero-delay links (the residual "
                "compensates the sender's quantizer at publish time; a "
                "delay ring would re-quantize the raw payload at "
                "delivery) — set delay=0 or error_feedback=False")

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def init_state(self, payload0, round0: int = 0) -> FabricState:
        """Fresh fabric state for payloads shaped like ``payload0``
        (V, T, D).  With ``NetConfig.warm_fill`` the mailboxes start
        from ``payload0`` (one metered out-of-band exchange); otherwise
        at zero, and neighbors look silent until their first delivery.
        """
        payload0 = self._f32(payload0)
        V, D, dev = self.V, self.D, self.device
        T = payload0.shape[1]
        f32 = dict(dtype=torch.float32, device=dev)
        box_shape = (V, T, D) if self.mode == "buffer" else (V, V, T, D)
        ef_shape = ((V, V, T, D) if self.error_feedback
                    and self.mode == "mailbox" else (1, 1, 1, 1))
        st = FabricState(
            mailbox=torch.zeros(box_shape, **f32),
            pub_hist=torch.zeros((self.hist_len, V, T, D), **f32),
            ok_hist=torch.zeros((self.hist_len, V, V), dtype=torch.bool,
                                device=dev),
            tc_hist=torch.zeros((self.hist_len, V), **f32),
            credit=torch.where(torch.isinf(self.bw_m), self.bw_m,
                               torch.maximum(self.bw_m, self.bytes_m)),
            round=torch.tensor(round0, dtype=torch.int32, device=dev),
            msgs_sent=torch.zeros((V, V), **f32),
            msgs_delivered=torch.zeros((V, V), **f32),
            warmfill_msgs=torch.zeros((), **f32),
            silence=torch.zeros((V, V), dtype=torch.int32, device=dev),
            ef_resid=torch.zeros(ef_shape, **f32),
        )
        if self.net.warm_fill:
            st = self.warm_fill(st, payload0)
        return st

    def warm_fill(self, st: FabricState, payload,
                  task_mask=None) -> FabricState:
        """Deliver ``payload`` (V, T, D) into the mailboxes out of band:
        the bootstrap at session start, and the Fig. 7 refresh on a task
        membership change.  ``task_mask`` (V, T) marks the entries whose
        membership changed; every changed task is republished network
        wide (column granularity).  None refreshes everything.
        Deliveries are quantized per edge like any message and counted
        in ``warmfill_msgs`` (task-vectors)."""
        payload = self._f32(payload)
        T = payload.shape[1]
        if task_mask is None:
            tcols = torch.ones((T,), dtype=torch.bool, device=self.device)
        else:
            tcols = self._f32(task_mask).amax(0) > 0
        n = self.adjf.sum() * tcols.sum()
        if self.mode == "buffer":
            box = torch.where(tcols[None, :, None], payload, st.mailbox)
            return st._replace(mailbox=box,
                               warmfill_msgs=st.warmfill_msgs + n)
        vals = self._per_edge_quant(
            payload[None].expand((self.V,) + payload.shape))
        sel = self.adj[:, :, None, None] & tcols[None, None, :, None]
        box = torch.where(sel, vals, st.mailbox)
        # an out-of-band delivery crossed every consensus edge: the
        # staleness clock restarts
        silence = torch.where(self.adj, torch.zeros_like(st.silence),
                              st.silence)
        return st._replace(mailbox=box, silence=silence,
                           warmfill_msgs=st.warmfill_msgs + n)

    def apply_membership(self, st: FabricState, gc, fill,
                         payload) -> FabricState:
        """Node-level membership maintenance on a mailbox fabric.

        ``gc`` (V,) bool marks nodes leaving gracefully this round: every
        receiver's mailbox column from such a sender zeroes out and its
        in-flight ring entries are cancelled (a crash does none of this:
        its stale values linger until the staleness policy ages them
        out).  ``fill`` (V,) bool marks nodes (re)joining: both
        directions of every consensus edge touching one warm-fill from
        ``payload`` (V, T, D), quantized per edge, metered in
        ``warmfill_msgs`` (T per touched edge), their staleness clocks
        reset.  All-false masks change nothing."""
        if self.mode == "buffer":
            raise ValueError("membership events need a mailbox-mode "
                             "fabric; build it with force_mailbox=True")
        dev = self.device
        gc = torch.as_tensor(gc, dtype=torch.bool, device=dev)
        fill = torch.as_tensor(fill, dtype=torch.bool, device=dev)
        payload = self._f32(payload)
        T = payload.shape[1]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        box = torch.where(gc[None, :, None, None], zero, st.mailbox)
        ok_hist = st.ok_hist & ~gc[None, None, :]
        ef_resid = st.ef_resid
        if self.error_feedback:
            # the leaver's quantizer state dies with its link
            ef_resid = torch.where(gc[None, :, None, None], zero, ef_resid)
        touched = self.adj & (fill[:, None] | fill[None, :])
        vals = self._per_edge_quant(
            payload[None].expand((self.V,) + payload.shape))
        box = torch.where(touched[:, :, None, None], vals, box)
        silence = torch.where(touched, torch.zeros_like(st.silence),
                              st.silence)
        n = touched.to(torch.float32).sum() * T
        return st._replace(mailbox=box, ok_hist=ok_hist,
                           ef_resid=ef_resid, silence=silence,
                           warmfill_msgs=st.warmfill_msgs + n)

    # ------------------------------------------------------------------
    # the per-round exchange
    # ------------------------------------------------------------------
    def _per_edge_quant(self, vals: torch.Tensor) -> torch.Tensor:
        """Each edge's wire format on gathered values (V, V, T, D); only
        the formats present on some edge are computed."""
        out = vals
        for code in self._codes:
            out = torch.where(self._code_sel[code],
                              pol.apply_quant(vals, code), out)
        return out

    def keep_masks(self, round0: int, rounds: int) -> torch.Tensor:
        """(rounds, V, V) bool on the device: which sends survive transit
        in each absolute round of ``[round0, round0 + rounds)``, the
        reference's drop stream (``prng.keep_masks``)."""
        return torch.as_tensor(
            prng.keep_masks(self.seed, round0, rounds, self.drop_np),
            device=self.device)

    def exchange(self, st: FabricState, payload: torch.Tensor, act,
                 links: Optional[torch.Tensor], task_counts=None, *,
                 rnd: Optional[int], keep: Optional[torch.Tensor]
                 ) -> Tuple[FabricState, torch.Tensor]:
        """Publish every active node's ``payload`` rows through the links.

        ``act`` (V,) gates the senders; ``links`` (V, V) bool is this
        round's availability (None: the consensus graph);
        ``task_counts`` (V,) each sender's live task vectors, which set
        its bytes (default: the whole task axis).  ``rnd`` is the state's
        absolute round and ``keep`` (V, V) this round's surviving sends
        (``keep_masks``), both required by a mailbox fabric (a buffer
        fabric ignores them): the caller draws the masks, so a round
        reads nothing back from the device.  Returns the new state and
        this round's charged bytes (a 0-d f32 tensor)."""
        T = payload.shape[1]
        dev = self.device
        if task_counts is None:
            task_counts = torch.full((self.V,), T,
                                     dtype=torch.float32, device=dev)
        task_counts = self._f32(task_counts)
        act = self._f32(act)
        nvec = task_counts[None, :]                # per edge [v, u]: u's
        sending = act > 0                          # (V,) senders
        if self.mode == "buffer":
            box = torch.where(sending[:, None, None], payload, st.mailbox)
            sent = (self.adj & sending[None, :]).to(torch.float32) * nvec
            bytes_now = (self.bytes_m * sent).sum()
            return st._replace(
                mailbox=box,
                round=st.round + 1,
                msgs_sent=st.msgs_sent + sent,
                msgs_delivered=st.msgs_delivered + sent,
            ), bytes_now

        if rnd is None or keep is None:
            raise ValueError("a mailbox fabric's exchange needs the round "
                             "(rnd=) and its drop mask (keep=, from "
                             "keep_masks)")
        L = self.hist_len
        # repro: noqa[host-sync-in-hot-path] — rnd is the host round counter the caller passes (an int); the mailbox slot is chosen on the host, nothing is read back
        k = int(rnd)
        slot = k % L
        pub_hist = st.pub_hist.clone()
        pub_hist[slot] = payload

        avail = self.adj if links is None else (links & self.adj)
        live = avail & sending[None, :]            # sender u computed
        cost = self.bytes_m * nvec                 # this round's bundle
        credit = torch.where(
            torch.isinf(self.bw_m), self.bw_m,
            torch.minimum(st.credit + self.bw_m,
                          torch.maximum(self.bw_m, cost)))
        attempt = live & (credit >= cost)          # bytes are charged here
        credit = credit - torch.where(attempt, cost, 0.0)
        sent_ok = attempt & keep                   # survives transit
        ok_hist = st.ok_hist.clone()
        ok_hist[slot] = sent_ok
        tc_hist = st.tc_hist.clone()
        tc_hist[slot] = task_counts

        # delivery: edge (u -> v) with delay d receives the payload
        # published at round k - d, iff that round's send succeeded,
        # charged at the send round's task count
        slots = torch.remainder(k - self.delay_m, L).long()
        delivered = ok_hist[slots, self._vv, self._uu] & (self.delay_m <= k)
        raw = pub_hist[slots, self._uu]                        # (V,V,T,D)
        ef_resid = st.ef_resid
        if self.error_feedback:
            # send Q(x + e), then e <- (x + e) - Q(x + e) wherever the
            # sender produced a message (transit loss is invisible to
            # it); the wire bytes are unchanged
            inp = raw + ef_resid
            vals = self._per_edge_quant(inp)
            ef_resid = torch.where(attempt[:, :, None, None], inp - vals,
                                   ef_resid)
        else:
            vals = self._per_edge_quant(raw)
        box = torch.where(delivered[:, :, None, None], vals, st.mailbox)
        # staleness clock: per-edge rounds since the last delivery
        silence = torch.where(
            self.adj, torch.where(delivered, torch.zeros_like(st.silence),
                                  st.silence + 1), st.silence)
        charged = torch.where(attempt, cost, 0.0)
        return st._replace(
            mailbox=box,
            pub_hist=pub_hist,
            ok_hist=ok_hist,
            tc_hist=tc_hist,
            credit=credit,
            round=st.round + 1,
            msgs_sent=st.msgs_sent + attempt.to(torch.float32) * nvec,
            msgs_delivered=(st.msgs_delivered
                            + delivered.to(torch.float32)
                            * tc_hist[slots, self._uu]),
            silence=silence,
            ef_resid=ef_resid,
        ), charged.sum()

    # ------------------------------------------------------------------
    # the consensus reduce
    # ------------------------------------------------------------------
    def reduce(self, st: FabricState) -> torch.Tensor:
        """Per-node sum of mailbox values over the consensus neighbors.

        Buffer mode is the expression of ``core._default_nbr_reduce``
        over the shared buffer, the keystone of the bitwise identity.
        With a ``stale_limit`` K (mailbox mode), a neighbor whose edge
        has been silent for more than K rounds is left out of the sum
        until it delivers again."""
        if self.mode == "buffer":
            # repro: noqa[raw-einsum-in-plan] — deliberate: must be the exact expression of core._default_nbr_reduce, the keystone of the identity fabric's bitwise equality with the vmap backend
            return torch.einsum("vu,...utd->...vtd", self.adjf, st.mailbox)
        w = self.adjf
        if self.stale_limit is not None:
            w = w * (st.silence <= self.stale_limit).to(torch.float32)
        return (w[:, :, None, None] * st.mailbox).sum(1)


def build_fabric(prob, net: pol.NetConfig, *,
                 force_mailbox: bool = False) -> Fabric:
    """A Fabric over a DTSVMProblem's consensus graph and vector size, on
    the problem's device."""
    p = prob.X.shape[-1]
    return Fabric(prob.adj, 2 * p + 2, net, force_mailbox=force_mailbox)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
def snapshot_state(st: FabricState) -> dict:
    """One FabricState as a name-keyed dict of numpy arrays, the form a
    snapshot stores; field names (not positions) key it."""
    return {k: v.detach().cpu().numpy() for k, v in st._asdict().items()}


def restore_state(tree, device=None) -> FabricState:
    """Rebuild a FabricState from ``snapshot_state``'s form (numpy arrays
    or tensors) on ``device`` (``None`` means ``"cuda"``).  Missing or
    unknown fields raise; each field's dtype is pinned (the round
    counter and staleness clock int32, the ok ring bool, the rest
    float32), whatever width the stored leaves have."""
    want = set(FabricState._fields)
    got = set(tree)
    if got != want:
        raise ValueError(
            f"fabric snapshot fields {sorted(got)} do not match "
            f"FabricState{sorted(want)}; run a schema migration "
            f"before restoring")
    dev = device_lib.resolve(device)
    dtypes = {"round": torch.int32, "ok_hist": torch.bool,
              "silence": torch.int32}

    def leaf(k, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        # a copy: a decoded snapshot's arrays are read-only views of the
        # file's bytes
        return torch.as_tensor(np.array(v), dtype=dtypes.get(
            k, torch.float32), device=dev)

    return FabricState(**{k: leaf(k, v) for k, v in tree.items()})
