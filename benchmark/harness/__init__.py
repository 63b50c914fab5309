"""The benchmark's general code: cells and their parts by name, seeded
weights and frames, the program's constructors, the run, the profiler
trace and the controls of `correct`.  The traffic drivers are in
benchmark/drivers/, the tasks' parts in benchmark/tasks/."""
