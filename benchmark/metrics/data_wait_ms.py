"""data_wait_ms (layer "data": ``data/dataset.py`` ``batches`` ->
``data/host_aug.py`` -> ``data/prefetch.py`` ``Prefetcher``): host
milliseconds a step that the trainer's epoch loop waited for its next
batch, over the window. The span is the harness's own, around each batch
the trainer takes from ``Trainer.prefetch``; it holds the decode and host
augmentation the staging thread has not finished, the pinned copy, and at
each epoch's start the prefetcher's first two batches. Moves
``train_img_per_s``.
"""


def read(reading):
    w = reading.window
    if w.steps == 0:
        return None
    return sum(w.data_wait_s) / w.steps * 1e3
