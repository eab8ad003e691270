"""device.idle_share.served: the share of the traced window's first
half, where no kernel wrapper runs, in which no operation ran on the device
(1 - union of device-busy intervals / the half's length), in percent."""


def read(obs):
    if obs.device is None or obs.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.device.busy_s / obs.device.window_s)
