"""Training batches and host-side audio IO and features of the port (the
dataset and loader come with the text slice)."""
