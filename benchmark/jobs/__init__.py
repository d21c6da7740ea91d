"""The jobs of the traffic mixes: one module a kind of mix, found by the
mix's ``jobs`` key.  Each module defines ``Jobs(config, mix, seed, device)``
with:

- ``n_inputs``: the distinct input sets made in set-up, used in turn;
- ``job(i)``: the timed call into the program on input set i;
- ``work(i)``: what a job on input i does, in the unit of the cell's rate;
- ``summary(result)``: what is kept of every job's answer;
- ``answer(result)``: the answer in the form the comparison reads;
- ``reference(i)`` and ``control(i)``: the plain reference's answer and
  the control's, in that form;
- ``compare(answer, ref)``: each number compared, by name;
- ``LIMITS``: each number's limit (a reading above it is not correct).

A module may offer more for its metric readers (``evalseg``: ``shapes(i)``).
"""
