"""Host seconds a scene setting up the global alignment: the `ga/setup`
span of `run_global_alignment` (`make_state` with its gathers' row
orders, `init_params`, the warm start), over the traced window's
requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "ga/setup")
