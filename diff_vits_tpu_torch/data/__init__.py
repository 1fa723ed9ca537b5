"""Training batches of the port (the dataset and loader come with the
audio and text slice)."""
