"""Clean twin: device values collected in the loop, converted after."""


def train(train_step, state, batches, writer):
    log = []
    for batch in batches:
        state, loss = train_step(state, batch)
        log.append(loss)
    for loss in log:
        writer.log(float(loss))
    return state
