"""One file per model family. Each builds the port's model from the weights
the benchmark drew (``reference/<family>.weights``, copied into the port's
own structures) and drives the timed entry. Its ``TASKS`` maps a traffic
mix's ``task`` to a class with:

  * ``__init__(cfg, mix, seed, device, control=False)``: set-up: weights,
    the inputs of every batch, the program (``control``: the reference in
    TF32 in the program's place);
  * ``unit`` ("maps", "samples") and ``batch_units``;
  * ``submit(i)`` → a handle; ``settle(handle)`` → the batch's record,
    once its outputs are on the host;
  * ``release()``: frees the program's state;
  * ``judge(kept)`` → ``{number: value}`` against the reference;
  * ``flops_per_unit()``: the frozen work count of one unit.
"""
