"""Seeded violations: per-iteration host conversions in driver loops."""


def train(train_step, state, batches, writer):
    for batch in batches:
        state, loss = train_step(state, batch)
        writer.log(float(loss))  # LINT: sync-in-loop
    return state


def evaluate(eval_step, state, batches):
    total = 0.0
    for batch in batches:
        counts = eval_step(state, batch)
        total += counts["top1"].item()  # LINT: sync-in-loop
        rows = counts["count"].cpu()  # LINT: sync-in-loop
    return total, rows
