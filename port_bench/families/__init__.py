"""Model families: the program side of each model the benchmark runs.

A configuration's ``model`` names its family.  The family is two files,
found by that name and by nothing else:

* ``families/<model>.py``, the program side, which gives

  - ``build(config, dtype)``: the port's module, called on the ``meta``
    device (the weights are the benchmark's, from the seed);
  - ``bind_loss(opt, module, aux)``: the family's loss bound to the
    port's optimizer (``opt.compile_step``), with the buffers ``aux``
    where the model has any;
  - ``batch_pool(traffic, config, seed, device)``: the traffic's pool of
    global batches, made on the device from the seed;
  - ``items_per_batch(traffic)``: what a global batch counts toward the
    cell's rate;
  - ``step_flops(config, traffic)``: one rank's model FLOPs a step,
    forward and backward;
  - optionally ``fan_in(name, shape)``: a leaf's fan-in for its LeCun
    scale, where it is not the product of the shape after the first
    axis (`data.default_fan_in`).

  It imports the port only inside ``build`` and ``bind_loss``.
* ``reference/<model>.py``, the plain reference (see
  ``reference/__init__.py``).

`spec.family` loads the first and refuses a name whose files are
missing.
"""
