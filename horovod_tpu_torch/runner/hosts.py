"""Host parsing and slot assignment for the launcher (port of
``horovod_tpu/runner/hosts.py``; reference:
horovod/runner/common/util/hosts.py ``parse_hosts``,
``get_host_assignments``): a job is a list of ``host:slots`` entries; the
launcher assigns each process a global rank, a per-host local rank, and a
cross rank (its host's index among hosts that carry the same local rank).
One slot is one worker process, one GPU.
"""


class HostInfo:
    __slots__ = ("hostname", "slots")

    def __init__(self, hostname, slots):
        if slots < 1:
            raise ValueError(f"host {hostname!r} must have >=1 slots")
        self.hostname = hostname
        self.slots = slots

    @classmethod
    def from_string(cls, host_string):
        parts = host_string.strip().split(":")
        if len(parts) == 1 or parts[1] == "":
            return cls(parts[0], 1)
        return cls(parts[0], int(parts[1]))

    def __repr__(self):
        return f"HostInfo({self.hostname}:{self.slots})"


class SlotInfo:
    __slots__ = ("hostname", "rank", "size", "local_rank", "local_size",
                 "cross_rank", "cross_size")

    def __init__(self, hostname, rank, size, local_rank, local_size,
                 cross_rank, cross_size):
        self.hostname = hostname
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size

    def to_env(self):
        """The env the worker's ``Topology.from_env`` reads (analog of the
        reference's slot env vars, horovod/runner/gloo_run.py:65-77)."""
        return {
            "HVDTPU_RANK": str(self.rank),
            "HVDTPU_SIZE": str(self.size),
            "HVDTPU_LOCAL_RANK": str(self.local_rank),
            "HVDTPU_LOCAL_SIZE": str(self.local_size),
            "HVDTPU_CROSS_RANK": str(self.cross_rank),
            "HVDTPU_CROSS_SIZE": str(self.cross_size),
        }

    def __repr__(self):
        return (f"SlotInfo({self.hostname} rank={self.rank}/{self.size} "
                f"local={self.local_rank}/{self.local_size} "
                f"cross={self.cross_rank}/{self.cross_size})")


def parse_hosts(hosts_string):
    """Parse ``host1:slots,host2:slots`` into HostInfo list."""
    hosts = [HostInfo.from_string(h) for h in hosts_string.split(",")
             if h.strip()]
    if not hosts:
        raise ValueError(f"no hosts in {hosts_string!r}")
    seen = set()
    for h in hosts:
        if h.hostname in seen:
            raise ValueError(f"duplicate host {h.hostname!r}")
        seen.add(h.hostname)
    return hosts


def parse_hostfile(path):
    """One ``host slots=N`` (or ``host:N`` / bare ``host``) per line."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "slots=" in line:
                name, _, slots = line.partition("slots=")
                hosts.append(HostInfo(name.strip(), int(slots.strip())))
            else:
                hosts.append(HostInfo.from_string(line))
    if not hosts:
        raise ValueError(f"hostfile {path} is empty")
    return hosts


def get_host_assignments(hosts, num_proc):
    """Assign ``num_proc`` ranks to hosts in order, filling each host's
    slots before moving on (reference semantics:
    horovod/runner/common/util/hosts.py get_host_assignments).

    Returns a list of SlotInfo ordered by rank. cross_size for a slot is
    the number of hosts that have a worker with the same local_rank;
    cross_rank is this host's index among them.
    """
    total = sum(h.slots for h in hosts)
    if total < num_proc:
        raise ValueError(
            f"requested {num_proc} processes but hosts provide only "
            f"{total} slots")
    # (hostname, local_rank) per rank, in rank order.
    placements = []
    for h in hosts:
        for local_rank in range(h.slots):
            if len(placements) == num_proc:
                break
            placements.append((h.hostname, local_rank))
        if len(placements) == num_proc:
            break

    local_sizes = {}
    for hostname, _ in placements:
        local_sizes[hostname] = local_sizes.get(hostname, 0) + 1
    # Hosts in first-rank order, for stable cross-rank numbering.
    host_order = list(dict.fromkeys(h for h, _ in placements))

    slots = []
    for rank, (hostname, local_rank) in enumerate(placements):
        hosts_at_lr = [h for h in host_order if local_sizes[h] > local_rank]
        slots.append(SlotInfo(
            hostname=hostname, rank=rank, size=num_proc,
            local_rank=local_rank, local_size=local_sizes[hostname],
            cross_rank=hosts_at_lr.index(hostname),
            cross_size=len(hosts_at_lr)))
    return slots
