"""Real output frames over rows x mel-bucket frames of every synthesize
call in the window (%): an exact count of the work not wasted on repeat
rows and bucket padding."""


def read(ctx):
    return ctx.get("frame_fill")
