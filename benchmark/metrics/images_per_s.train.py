"""Images trained a second: the batch times the ``Trainer.train``
iterations completed in the traced run's window, over that window (a
synchronize at each of the trainer's marks, so below an untraced run's
rate)."""


def read(layer):
    images, window = layer.get("images"), layer.get("window_s")
    if not images or not window:
        return None
    return images / window
