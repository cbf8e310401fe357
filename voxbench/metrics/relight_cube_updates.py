"""The relight driver's work: `evaluate_light`'s own return (cube updates;
a dense pass counts every cube), mean a settled event over the window."""


def read(run, driver):
    return run.counters.get("relight_cube_updates")
