"""How each deployment is built from the port and fed: one module a
system kind, named by a configuration's ``"system"`` key.  A system
module defines ``System(config, mix, seed, device)`` with:

* ``warm_chunks()``: the chunks set-up runs through a pipeline of the
  cell's own shapes before the window;
* ``make_chunk(c, t)``: chunk c of the stream (t: seconds since the
  window opened, the chunk's time stamp where the stream carries one);
* ``pipeline(chunks, on_rows)``: a fresh pipeline of the port fed from
  the iterable `chunks`, every result batch passed to `on_rows`; it has
  ``run_and_wait_end()``;
* ``farm``: the name of its window stage (the key farm), whose replicas
  are the nodes ``<farm>.<i>``;
* ``columns(rows)``: (key, window, values) of a result batch;
* ``expected(paced, acc=None)``: (index, values) of the results due for
  the chunks `paced` sent, by the plain reference (with `acc`, the
  reference's accumulator narrowed to that dtype: the control).
"""
