"""Vectorized chess endgames: FEN/SAN legality as batched tensor code.

The port of `lmrl_gym_tpu/envs/chess/vector.py`: KQ-K and KR-K endgames
(reference llm_rl_scripts/chess/env/env.py:246-260), where the agent
(white) has king and one major piece and the opponent a lone king. With
three pieces the rules reduce to precomputed 64x64(x64) adjacency,
alignment and between tables, built once with numpy and moved to the
device with the env, so batched reset and step run entirely on the card.

Semantics as the host ChessGame (envs/chess/env.py):
  illegal SAN        -> reward -1, episode continues, board unchanged
  agent checkmates   -> +1, done
  stalemate / queen captured / 75-move rule -> 0, done
  opponent           -> a uniform-random legal king move
No fivefold-repetition draw (the 75-move rule bounds episodes), and
`reset` samples valid positions by fixed-attempt rejection.

Token protocol (the fused actor's frames):
  obs = the FEN spelled char by char, space-separated, space-padded to a
        static width, '\\n' last (or, in 'grid' mode, an 8x8 board)
  act = the SAN spelled char by char ("Q f 7\\n") in a static ACT_LEN
        field; the parser reads even slots up to '\\n'

Every random choice samples as `jax.random` does: `reset`'s squares as
`randint((3, 8, B), 0, 64)`, the black reply and `random_legal_action` as
the argmax of Gumbel noise plus the masked logits. Each comes from an
explicit `torch.Generator` or from draws the caller hands in. Table
lookups at a captured piece (pc = -1) clamp the index as the JAX package
does, so nothing reads out of range on the card.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmrl_gym_torch.core.device import DeviceLike, resolve_device
from lmrl_gym_torch.core.random import categorical

# ---------------------------------------------------------------- tables
# square 0..63 = a1..h8 (sq = rank*8 + file)


@functools.lru_cache(maxsize=1)
def build_tables() -> dict:
    """The numpy tables: king adjacency, rook/queen alignment, the squares
    strictly between two aligned squares, and the 8 king-move targets per
    square (-1 off the board)."""
    adj = np.zeros((64, 64), bool)
    r_aligned = np.zeros((64, 64), bool)
    b_aligned = np.zeros((64, 64), bool)
    between = np.zeros((64, 64, 64), bool)
    for a in range(64):
        ra, fa = divmod(a, 8)
        for b in range(64):
            if a == b:
                continue
            rb, fb = divmod(b, 8)
            if max(abs(ra - rb), abs(fa - fb)) == 1:
                adj[a, b] = True
            dr, df = rb - ra, fb - fa
            if dr == 0 or df == 0:
                r_aligned[a, b] = True
            elif abs(dr) == abs(df):
                b_aligned[a, b] = True
            else:
                continue
            sr = (dr > 0) - (dr < 0)
            sf = (df > 0) - (df < 0)
            r, f = ra + sr, fa + sf
            while (r, f) != (rb, fb):
                between[a, b, r * 8 + f] = True
                r, f = r + sr, f + sf
    king_tgt = np.full((64, 8), -1, np.int64)
    for a in range(64):
        ra, fa = divmod(a, 8)
        k = 0
        for dr in (-1, 0, 1):
            for df in (-1, 0, 1):
                if dr == df == 0:
                    continue
                r, f = ra + dr, fa + df
                if 0 <= r < 8 and 0 <= f < 8:
                    king_tgt[a, k] = r * 8 + f
                k += 1
    return dict(adj=adj, r_aligned=r_aligned, b_aligned=b_aligned, q_aligned=r_aligned | b_aligned,
                between=between, king_tgt=king_tgt)


_NL, _SP = 10, 32
ACT_LEN = 8  # "Q f 7 #\n" worst case: 4 SAN chars spelled
FEN_MAX = 48  # 3-piece board field <= 33 chars + " w - - HHH FFF"
OBS_LEN = 2 * FEN_MAX  # spelled chars + separators, '\n' in the last slot


class ChessVecState(NamedTuple):
    wk: torch.Tensor  # [B] int64 white king square
    pc: torch.Tensor  # [B] int64 white major piece square, -1 if captured
    bk: torch.Tensor  # [B] int64 black king square
    halfmove: torch.Tensor  # [B] int32 FEN halfmove clock
    fullmove: torch.Tensor  # [B] int32 FEN fullmove number
    n_steps: torch.Tensor  # [B] int32 agent actions taken (incl. illegal)
    done: torch.Tensor  # [B] bool
    reward: torch.Tensor  # [B] float32 — last step's reward
    illegal: torch.Tensor  # [B] bool — last step was an illegal action


def state_slice(state: ChessVecState, idx) -> ChessVecState:
    """The rows `idx` (a slice or an index tensor) of every field."""
    return ChessVecState(*(x[idx] for x in state))


class ChessEndgameVectorEnv:
    """Batched KQ-K / KR-K endgame with a random-mover opponent."""

    OBS_LEN = OBS_LEN
    ACT_LEN = ACT_LEN

    def __init__(self, piece: str = "Q", max_steps: int = 50, obs_mode: str = "fen", device: DeviceLike = None):
        """obs_mode: 'fen' — the reference protocol, the FEN spelled char by
        char; 'grid' — an 8x8 board ('.', 'K', 'Q'/'R', 'k' per square,
        rank 8 first, one rank per line), which a small trunk trained from
        scratch reads more easily than FEN's run lengths."""
        assert piece in ("Q", "R")
        assert obs_mode in ("fen", "grid")
        self.device = resolve_device(device)
        self.piece = piece
        self.piece_byte = ord(piece)
        self.max_steps = max_steps
        self.obs_mode = obs_mode
        if obs_mode == "grid":
            self.OBS_LEN = 8 * 9  # 8 squares + '\n' per rank, 8 ranks
        t = build_tables()
        dev = self.device
        self.adj = torch.as_tensor(t["adj"], device=dev)
        self.aligned = torch.as_tensor(t["q_aligned"] if piece == "Q" else t["r_aligned"], device=dev)
        self.between = torch.as_tensor(t["between"], device=dev)
        self.king_tgt = torch.as_tensor(t["king_tgt"], device=dev)

    def _piece_attacks(self, pc, target, blocker):
        """Does the major piece on `pc` attack `target` with one `blocker`
        square occupied? (pc may be -1 = captured; its lookups clamp.)"""
        pcc = pc.clamp(0, 63)
        att = self.aligned[pcc, target] & ~self.between[pcc, target, blocker]
        return att & (pc >= 0) & (pc != target)

    # ------------------------------------------------------------ reset

    def reset(self, batch: int, generator: Optional[torch.Generator] = None,
              squares: Optional[torch.Tensor] = None) -> ChessVecState:
        """Uniform over valid (wk, pc, bk) placements — white to move, kings
        apart, black not in check — by 8-attempt rejection per slot (a
        fixed fallback position after that). `squares` [3, 8, B] replays
        the attempts' draws."""
        K, B, dev = 8, batch, self.device
        if squares is None:
            sq = torch.randint(0, 64, (3, K, B), generator=generator, device=dev)
        else:
            sq = squares.to(dev).long()
        wk, pc, bk = sq[0], sq[1], sq[2]
        distinct = (wk != pc) & (wk != bk) & (pc != bk)
        apart = ~self.adj[wk, bk]
        no_check = ~self._piece_attacks(pc, bk, wk)
        ok = distinct & apart & no_check  # [K, B]
        pick = torch.argmax(ok.to(torch.int32), dim=0)  # the first valid attempt
        any_ok = ok.any(dim=0)
        cols = torch.arange(B, device=dev)

        def take(a, fallback):
            return torch.where(any_ok, a[pick, cols], fallback)

        return ChessVecState(
            wk=take(wk, 0), pc=take(pc, 8), bk=take(bk, 63),
            halfmove=torch.zeros((B,), dtype=torch.int32, device=dev),
            fullmove=torch.ones((B,), dtype=torch.int32, device=dev),
            n_steps=torch.zeros((B,), dtype=torch.int32, device=dev),
            done=torch.zeros((B,), dtype=torch.bool, device=dev),
            reward=torch.zeros((B,), dtype=torch.float32, device=dev),
            illegal=torch.zeros((B,), dtype=torch.bool, device=dev),
        )

    # --------------------------------------------------- move legality

    def agent_legal_moves(self, state: ChessVecState) -> Tuple[torch.Tensor, torch.Tensor]:
        """([B,64] king-move mask, [B,64] piece-move mask) of legal
        destination squares for the side to move (white)."""
        dst = torch.arange(64, device=self.device)[None, :]
        wk_, pc_, bk_ = state.wk[:, None], state.pc[:, None], state.bk[:, None]
        k_legal = self.adj[wk_, dst] & (dst != pc_) & (dst != bk_) & ~self.adj[dst, bk_]
        pcc = pc_.clamp(0, 63)
        p_legal = (
            (pc_ >= 0)
            & self.aligned[pcc, dst]
            & (dst != wk_)
            & (dst != bk_)
            & ~self.between[pcc, dst, wk_]
            & ~self.between[pcc, dst, bk_]
        )
        return k_legal, p_legal

    def _black_replies(self, wk, pc, bk):
        """([B,8] legal-reply mask, [B,8] target squares) for the lone king
        on `bk` against {wk, pc}: on the board, not the white king's square,
        not attacked with the black king removed from its old square, and
        the piece's square only by an undefended capture. Off-board targets
        (-1) read square 0, masked out."""
        tgt = self.king_tgt[bk]  # [B, 8]
        on_board = tgt >= 0
        t = tgt.clamp(min=0)
        wk_, pc_ = wk[:, None], pc[:, None]
        is_cap = t == pc_
        attacked = self.adj[wk_, t] | self._piece_attacks(pc_.expand_as(t), t, wk_.expand_as(t))
        cap_ok = is_cap & ~self.adj[wk_, t]  # capturing the piece: only the king defends it
        legal = on_board & (t != wk_) & torch.where(is_cap, cap_ok, ~attacked)
        return legal, t

    def black_in_check(self, state: ChessVecState) -> torch.Tensor:
        return self._piece_attacks(state.pc, state.bk, state.wk)

    # ------------------------------------------------------------- step

    def step(self, state: ChessVecState, act_tokens: torch.Tensor, generator: Optional[torch.Generator] = None,
             noise: Optional[torch.Tensor] = None) -> ChessVecState:
        """act_tokens: [B, ACT_LEN] byte tokens of a spelled SAN field. Parse
        → legality → apply → terminal checks → random black reply (Gumbel
        `noise` [B, 8], or drawn from `generator`) → terminal checks."""
        B = act_tokens.shape[0]
        piece_ch, dst, parse_ok = _parse_san_frame(act_tokens.long(), self.piece_byte)

        k_legal, p_legal = self.agent_legal_moves(state)
        is_king = piece_ch == ord("K")
        is_piece = piece_ch == self.piece_byte
        dmask = F.one_hot(dst, 64).bool()
        legal = parse_ok & (
            (is_king & (k_legal & dmask).any(dim=1)) | (is_piece & (p_legal & dmask).any(dim=1))
        )

        # white's move
        wk1 = torch.where(legal & is_king, dst, state.wk)
        pc1 = torch.where(legal & is_piece, dst, state.pc)
        half1 = torch.where(legal, state.halfmove + 1, state.halfmove)

        # black's status after it
        in_check = self._piece_attacks(pc1, state.bk, wk1)
        replies, tgts = self._black_replies(wk1, pc1, state.bk)
        no_reply = ~replies.any(dim=1)
        mate = legal & in_check & no_reply
        stalemate = legal & ~in_check & no_reply
        draw75_w = legal & (half1 >= 150)
        over_after_white = mate | stalemate | draw75_w

        # a random legal black reply (for games still running)
        logits = torch.where(replies, 0.0, -torch.inf)
        safe_logits = torch.where(replies.any(dim=1, keepdim=True), logits, 0.0)
        choice = categorical(safe_logits, generator, None if noise is None else noise.to(self.device))
        bk1 = tgts[torch.arange(B, device=self.device), choice]
        captured = bk1 == pc1
        do_reply = legal & ~over_after_white
        bk2 = torch.where(do_reply, bk1, state.bk)
        pc2 = torch.where(do_reply & captured, -1, pc1)
        half2 = torch.where(do_reply, torch.where(captured, 0, half1 + 1), half1).to(torch.int32)
        full2 = torch.where(do_reply, state.fullmove + 1, state.fullmove)

        # terminal checks after black's reply
        material_draw = do_reply & (pc2 < 0)
        draw75_b = do_reply & (half2 >= 150)

        n_steps = state.n_steps + 1
        timeout = n_steps >= self.max_steps

        done = over_after_white | material_draw | draw75_b | timeout
        reward = torch.where(mate, 1.0, torch.where(legal, 0.0, -1.0)).float()

        frozen = state.done

        def keep(old, new):
            return torch.where(frozen, old, new)

        return ChessVecState(
            wk=keep(state.wk, wk1),
            pc=keep(state.pc, pc2),
            bk=keep(state.bk, bk2),
            halfmove=keep(state.halfmove, half2),
            fullmove=keep(state.fullmove, full2),
            n_steps=keep(state.n_steps, n_steps),
            done=keep(state.done, done),
            reward=torch.where(frozen, 0.0, reward),
            illegal=~frozen & ~legal,
        )

    # ------------------------------------------------- token rendering

    def obs_tokens(self, state: ChessVecState) -> torch.Tensor:
        """[B, OBS_LEN] int64. 'fen': the FEN spelled char by char with
        space separators, space-padded, '\\n' last. 'grid': 72 tokens,
        squares a8..h8 '\\n' ... a1..h1 '\\n'."""
        if self.obs_mode == "grid":
            return self._grid_tokens(state)
        chars, length = self._fen_chars(state)
        B = chars.shape[0]
        out = torch.full((B, OBS_LEN), _SP, dtype=torch.int64, device=self.device)
        idx = torch.arange(FEN_MAX, device=self.device)[None, :]
        out[:, 0::2] = torch.where(idx < length[:, None], chars, _SP)
        out[:, OBS_LEN - 1] = _NL
        return out

    def _grid_tokens(self, state: ChessVecState) -> torch.Tensor:
        B = state.wk.shape[0]
        rows = torch.arange(B, device=self.device)
        board = torch.full((B, 64), ord("."), dtype=torch.int64, device=self.device)
        board[rows, state.wk] = ord("K")
        # pc == -1 once captured: write the square's own value at a clamped index
        pc_safe = state.pc.clamp(0, 63)
        board[rows, pc_safe] = torch.where(state.pc >= 0, self.piece_byte, board[rows, pc_safe])
        board[rows, state.bk] = ord("k")
        # square index = rank*8 + file; rank 8 (squares 56..63) first
        grid = board.reshape(B, 8, 8).flip(1)
        out = torch.full((B, 8, 9), _NL, dtype=torch.int64, device=self.device)
        out[:, :, :8] = grid
        return out.reshape(B, 72)

    def _fen_chars(self, state: ChessVecState) -> Tuple[torch.Tensor, torch.Tensor]:
        """([B, FEN_MAX] char codes, [B] length): the run-length-encoded
        board and the ' w - - H F' suffix, put together by one compaction
        scatter. Every dropped character goes to the spare slot
        FEN_MAX + 7, which is sliced off (as the JAX package's drop-mode
        scatter writes it), so duplicate writes land only there."""
        B, dev = state.wk.shape[0], self.device
        sq = torch.arange(64, device=dev)[None, :]
        board = torch.zeros((B, 64), dtype=torch.int64, device=dev)
        board = torch.where(sq == state.wk[:, None], ord("K"), board)
        board = torch.where((sq == state.pc[:, None]) & (state.pc[:, None] >= 0), self.piece_byte, board)
        board = torch.where(sq == state.bk[:, None], ord("k"), board)
        # FEN ranks go 8 → 1: rank r emits files 0..7 of board rank 7 - r
        b8 = board.reshape(B, 8, 8).flip(1)  # [B, rank from the top, file]
        occ = b8 > 0

        # per (rank, file): the run of empty squares since the last piece
        file_idx = torch.arange(8, device=dev)
        occ_files = torch.where(occ, file_idx[None, None, :], -1)
        prev = torch.cummax(occ_files, dim=2).values  # the last occupied file <= f
        prev_before = torch.cat([torch.full((B, 8, 1), -1, dtype=prev.dtype, device=dev), prev[:, :, :-1]], dim=2)
        run_before = file_idx[None, None, :] - prev_before - 1  # empties before the piece
        run_tail = torch.where(prev[:, :, 7] < 0, 8, 7 - prev[:, :, 7])  # empties after the last piece

        # the slot grid per rank: (digit?, piece?) x 8 files + tail digit + '/'
        zero = ord("0")
        slot_chars = torch.zeros((B, 8, 18), dtype=torch.int64, device=dev)
        slot_valid = torch.zeros((B, 8, 18), dtype=torch.bool, device=dev)
        slot_chars[:, :, 0:16:2] = zero + run_before
        slot_valid[:, :, 0:16:2] = occ & (run_before > 0)
        slot_chars[:, :, 1:16:2] = b8
        slot_valid[:, :, 1:16:2] = occ
        slot_chars[:, :, 16] = zero + run_tail
        slot_valid[:, :, 16] = run_tail > 0
        slot_chars[:, :, 17] = ord("/")
        slot_valid[:, :, 17] = True
        slot_valid[:, 7, 17] = False  # no trailing '/'

        def num_slots(n):
            """Up to 3 digits (clamped to 999), leading zeros dropped."""
            n = n.long().clamp(max=999)
            d2, d1, d0 = n // 100, (n // 10) % 10, n % 10
            chars = torch.stack([zero + d2, zero + d1, zero + d0], dim=-1)
            valid = torch.stack([d2 > 0, (d2 > 0) | (d1 > 0), torch.ones_like(d0, dtype=torch.bool)], dim=-1)
            return chars, valid

        hc, hv = num_slots(state.halfmove)
        fc, fv = num_slots(state.fullmove)
        fixed = torch.tensor([ord(c) for c in " w - - "], dtype=torch.int64, device=dev)
        suf_chars = torch.cat([fixed.expand(B, 7), hc, torch.full((B, 1), _SP, dtype=torch.int64, device=dev), fc],
                              dim=1)
        suf_valid = torch.cat([torch.ones((B, 7), dtype=torch.bool, device=dev), hv,
                               torch.ones((B, 1), dtype=torch.bool, device=dev), fv], dim=1)

        chars = torch.cat([slot_chars.reshape(B, -1), suf_chars], dim=1)
        valid = torch.cat([slot_valid.reshape(B, -1), suf_valid], dim=1)
        pos = torch.cumsum(valid.long(), dim=1) - 1
        pos = torch.where(valid, pos, FEN_MAX + 7)  # the spare slot
        out = torch.full((B, FEN_MAX + 8), _SP, dtype=torch.int64, device=dev)
        out.scatter_(1, pos, chars)
        return out[:, :FEN_MAX], valid.sum(dim=1).to(torch.int32)

    # ------------------------------------------------- helper policies

    def random_legal_action(self, state: ChessVecState, generator: Optional[torch.Generator] = None,
                            gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, ACT_LEN] frame of a uniformly random legal move (Gumbel
        `gumbel` [B, 128] over king then piece destinations, or drawn from
        `generator`): the scripted behavior policy of the offline data."""
        k_legal, p_legal = self.agent_legal_moves(state)
        both = torch.cat([k_legal, p_legal], dim=1)  # [B, 128]
        logits = torch.where(both, 0.0, -torch.inf)
        safe = torch.where(both.any(dim=1, keepdim=True), logits, 0.0)
        choice = categorical(safe, generator, None if gumbel is None else gumbel.to(self.device))
        return self.render_san(choice < 64, choice % 64)

    def render_san(self, is_king: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
        """[B, ACT_LEN] frame "K e 4\\n" / "Q f 7\\n" (no check suffix — the
        SAN parsers accept it as optional)."""
        B = dst.shape[0]
        dst = dst.to(self.device).long()
        out = torch.full((B, ACT_LEN), _SP, dtype=torch.int64, device=self.device)
        out[:, 0] = torch.where(is_king.to(self.device), ord("K"), self.piece_byte)
        out[:, 2] = ord("a") + dst % 8
        out[:, 4] = ord("1") + dst // 8
        out[:, 5] = _NL
        return out

    def fen_strings(self, state: ChessVecState) -> List[str]:
        """The FEN of every row, decoded on the host."""
        chars, length = self._fen_chars(state)
        chars, length = chars.cpu().numpy(), length.cpu().numpy()
        return [bytes(c[: int(n)].astype(np.uint8)).decode() for c, n in zip(chars, length)]


def _parse_san_frame(act_tokens: torch.Tensor, piece_byte: int):
    """Parse a spelled SAN field: chars at even slots, spaces at odd slots,
    '\\n' terminates. Returns (piece_char [B], dst square [B], parse_ok [B]).

    Grammar: [KQR][a-h][1-8] with an optional trailing '+' or '#' (not
    validated, as the native SAN parser). Anything else (captures 'x',
    pawn moves, castling, bad separators) parses as invalid, which the env
    scores illegal. A row without '\\n' reads its first '\\n' at slot 0 (as
    an argmax over an all-false row does) and fails `has_nl`."""
    B, L = act_tokens.shape
    toks = act_tokens
    is_nl = toks == _NL
    has_nl = is_nl.any(dim=1)
    nl_pos = torch.argmax(is_nl.to(torch.int32), dim=1)  # the first '\n'

    # chars sit at even slots strictly before nl_pos, separators at odd ones
    idx = torch.arange(L, device=toks.device)[None, :]
    before = idx < nl_pos[:, None]
    sep_ok = torch.where(before & (idx % 2 == 1), toks == _SP, True).all(dim=1)
    n_chars = (nl_pos + 1) // 2  # '\n' sits at odd slot 2k-1 for k chars
    nl_odd = nl_pos % 2 == 1

    def c(k):  # char k, zeros past the field
        return toks[:, 2 * k] if 2 * k < L else torch.zeros((B,), dtype=toks.dtype, device=toks.device)

    c0, c1, c2, c3 = c(0), c(1), c(2), c(3)
    piece_ok = (c0 == ord("K")) | (c0 == piece_byte)
    file_ok = (c1 >= ord("a")) & (c1 <= ord("h"))
    rank_ok = (c2 >= ord("1")) & (c2 <= ord("8"))
    suffix_ok = (n_chars == 3) | ((n_chars == 4) & ((c3 == ord("+")) | (c3 == ord("#"))))
    parse_ok = has_nl & nl_odd & sep_ok & piece_ok & file_ok & rank_ok & suffix_ok
    dst = ((c2 - ord("1")) * 8 + (c1 - ord("a"))).clamp(0, 63)
    return c0, dst, parse_ok
