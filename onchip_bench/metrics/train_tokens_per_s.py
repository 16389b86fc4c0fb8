"""``train_tokens_per_s``: the tokens of every step of the window over the
seconds from the window's start to the end of its last step."""


def read(ctx):
    return ctx.window["tokens"] / ctx.window["seconds"]
