"""``valid_row_share.<cell>``: the share of the block steps' token rows
that carry a token, in percent.

Sum of each tick's valid tokens (the step input ``n_valid``) over the sum
of slots x T, over the window's ticks: a tick is T = chunk for every slot
while any one slot prefills, so the rest of its rows are wasted.
"""


def read(name, rec):
    ticks = rec.window_ticks()
    rows = sum(len(t.n_valid) * t.t_len for t in ticks)
    if not rows:
        return None
    return 100.0 * sum(int(t.n_valid.sum()) for t in ticks) / rows
