"""Adapters from a configuration's ``entry`` to the program's call: one
module per entry, named as the configuration names it, each with a class
``Entry(config, frames, device)`` that has ``thread_context(k)`` and
``call(frame_ids) -> list of (H, W, 3) RGB tensors``, ready on the device
when it returns."""
