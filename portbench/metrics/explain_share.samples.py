"""``explain_share.samples``: of the device time that the perturbation
runner's explanation (``_explain``) and its perturbed forwards
(``_forward_scores``) launch, the explanation's percent. The driver wraps
both methods in ``portbench.explain`` and ``portbench.forward`` ranges in a
traced run; each device operation counts for the range its launch ran
in."""


def read(run):
    if run.trace is None or run.driver.unit != "samples":
        return None
    of = run.trace.range_of_launch({"portbench.explain", "portbench.forward"})
    time = {"portbench.explain": 0, "portbench.forward": 0}
    for _, s, e, corr in run.trace.in_window():
        if corr in of:
            time[of[corr]] += e - s
    total = sum(time.values())
    return 100.0 * time["portbench.explain"] / total if total else None
