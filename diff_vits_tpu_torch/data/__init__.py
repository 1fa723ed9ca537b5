"""The port's data layer: training batches, datasets and loaders (Python
and native), offline preprocessing, and host-side audio IO and
features."""
