"""Remote-node scripting helpers: daemons, archives, downloads, files.

Reference: `jepsen/src/jepsen/control/util.clj` — `await-tcp-port` (:14),
`exists?`/`ls` (:38-61), `tmp-file!`/`tmp-dir!` (:63-86), `write-file!`
(:88), wget + control-node-keyed cache (:104-197), `install-archive!`
(:199-275), `grepkill!` (:286-308), `start-daemon!`/`stop-daemon!` via
start-stop-daemon (:310-384), `signal!` (:399).
"""

from __future__ import annotations

import base64
import logging
import os.path
import random

from .. import util
from . import exec_, ssh_star, var
from .core import RemoteError, env as make_env, escape, lit, \
    throw_on_nonzero_exit
from . import cd

log = logging.getLogger(__name__)

TMP_DIR_BASE = "/tmp/jepsen"
WGET_CACHE_DIR = TMP_DIR_BASE + "/wget-cache"

STD_WGET_OPTS = ["--tries", "20", "--waitretry", "60",
                 "--retry-connrefused", "--dns-timeout", "60",
                 "--connect-timeout", "60", "--read-timeout", "60"]


def meh(f):
    """Run f(), swallowing RemoteErrors (the reference's `meh`)."""
    try:
        return f()
    except RemoteError:
        return None


def await_tcp_port(port: int, retry_interval: float = 1.0,
                   timeout: float = 60.0) -> None:
    """Block until a TCP port is bound on the current node
    (`control/util.clj:14-30`)."""
    util.await_fn(lambda: exec_("nc", "-z", "localhost", port) and None,
                  retry_interval=retry_interval, timeout_secs=timeout,
                  log_message=f"Waiting for port {port} ...")


def exists(filename: str) -> bool:
    """Is a path present? (`control/util.clj:38-43`)"""
    try:
        exec_("stat", filename)
        return True
    except RemoteError:
        return False


def ls(dir: str = ".") -> list[str]:
    """Directory entries, not including . and .. (`control/util.clj:45-51`)."""
    out = exec_("ls", "-A", dir)
    return [l for l in out.split("\n") if l.strip()]


def ls_full(dir: str) -> list[str]:
    """ls with dir prepended to each entry (`control/util.clj:53-61`)."""
    if not dir.endswith("/"):
        dir = dir + "/"
    return [dir + e for e in ls(dir)]


def tmp_file() -> str:
    """A fresh random file under /tmp/jepsen (`control/util.clj:63-76`)."""
    while True:
        f = f"{TMP_DIR_BASE}/{random.randrange(2**31)}"
        if exists(f):
            continue
        try:
            exec_("touch", f)
        except RemoteError:
            exec_("mkdir", "-p", TMP_DIR_BASE)
            exec_("touch", f)
        return f


def tmp_dir() -> str:
    """A fresh random directory under /tmp/jepsen
    (`control/util.clj:78-86`)."""
    while True:
        d = f"{TMP_DIR_BASE}/{random.randrange(2**31)}"
        if exists(d):
            continue
        exec_("mkdir", "-p", d)
        return d


def write_file(content: str, file: str) -> str:
    """Write a string to a remote file via `cat > file` with the content
    on stdin — sudo- and dir-aware via ssh_star's wrapping
    (`control/util.clj:88-102`)."""
    throw_on_nonzero_exit(ssh_star({
        "cmd": f"cat > {escape(file)}", "in": content}))
    return file


def _wget_auth(user: str | None, pw: str | None) -> list[str]:
    if not user:
        return []
    if pw is None:
        raise ValueError("wget auth requires both user and pw")
    return ["--user", user, "--password", pw]


def _wget_helper(*args) -> str:
    """wget with retries on network errors (exit 4)
    (`control/util.clj:113-127`)."""
    tries = 5
    while True:
        try:
            return exec_("wget", *args)
        except RemoteError as e:
            if e.exit == 4 and tries > 0:
                tries -= 1
                continue
            raise


def wget(url: str, force: bool = False, user: str | None = None,
         pw: str | None = None) -> str:
    """Download url to the cwd; skips if present; returns the filename
    (`control/util.clj:133-156`)."""
    filename = os.path.basename(url)
    if force:
        exec_("rm", "-f", filename)
    opts = list(STD_WGET_OPTS) + _wget_auth(user, pw)
    if not exists(filename):
        _wget_helper(*opts, url)
    return filename


def cached_wget(url: str, force: bool = False, user: str | None = None,
                pw: str | None = None) -> str:
    """Download url into the wget cache, keyed by base64(url) so that
    version-in-URL-but-not-filename packages can't alias
    (`control/util.clj:167-197`)."""
    encoded = base64.b64encode(url.encode()).decode()
    dest = f"{WGET_CACHE_DIR}/{encoded}"
    # download to a .part name, rename on success: a failed download must
    # not leave a partial file that later calls mistake for a cached one
    opts = list(STD_WGET_OPTS) + ["-O", dest + ".part"]
    opts += _wget_auth(user, pw)
    if force:
        log.info("Clearing cached copy of %s", url)
        exec_("rm", "-rf", dest)
    if not exists(dest):
        log.info("Downloading %s", url)
        exec_("mkdir", "-p", WGET_CACHE_DIR)
        with cd(WGET_CACHE_DIR):
            _wget_helper(*opts, url)
            exec_("mv", dest + ".part", dest)
    return dest


def install_archive(url: str, dest: str, force: bool = False,
                    user: str | None = None, pw: str | None = None,
                    _retry: bool = True) -> str:
    """Fetch a tarball/zip (file:// or cached wget), extract, and move its
    sole top-level dir's contents (or all roots) to dest
    (`control/util.clj:199-275`)."""
    from . import expand_path

    local = url[len("file://"):] if url.startswith("file://") else None
    file = local or cached_wget(url, force=force, user=user, pw=pw)
    tmpdir = tmp_dir()
    dest = expand_path(dest)
    exec_("rm", "-rf", dest)
    parent = exec_("dirname", dest)
    exec_("mkdir", "-p", parent)
    try:
        with cd(tmpdir):
            if url.endswith(".zip"):
                exec_("unzip", file)
            else:
                exec_("tar", "--no-same-owner", "--no-same-permissions",
                      "--extract", "--file", file)
            if var("sudo") == "root":
                exec_("chown", "-R", "root:root", ".")
            roots = ls()
            assert roots, "Archive contained no files"
            if len(roots) == 1:
                exec_("mv", roots[0], dest)
            else:
                exec_("mv", tmpdir, dest)
    except RemoteError as e:
        err = e.err or ""
        corrupt = any(m in err for m in
                      ("tar: Unexpected EOF",
                       "This does not look like a tar archive",
                       "cannot find zipfile directory"))
        if corrupt and not local and _retry:
            log.info("Retrying corrupt archive download")
            exec_("rm", "-rf", file)
            return install_archive(url, dest, force=True, user=user,
                                   pw=pw, _retry=False)
        if corrupt and local:
            raise RemoteError(
                f"Local archive {local} on node {var('host')} is "
                f"corrupt: {err}", e.result)
        raise
    finally:
        meh(lambda: exec_("rm", "-rf", tmpdir))
    return dest


def ensure_user(username: str) -> str:
    """Make sure a user exists (`control/util.clj:277-284`)."""
    from . import su

    try:
        with su():
            exec_("adduser", "--disabled-password", "--gecos", lit("''"),
                  username)
    except RemoteError as e:
        if "already exists" not in (e.err or "") + str(e):
            raise
    return username


def grepkill(pattern: str, signal="9") -> None:
    """Kill processes matching a pattern. Can't pkill: sudo runs inside a
    `bash -c` wrapper whose argv would match and kill itself — so
    ps|grep|grep -v grep|awk|xargs kill (`control/util.clj:286-308`)."""
    sig = str(signal).lstrip(":").upper() if isinstance(signal, str) \
        else str(signal)
    try:
        exec_("ps", "aux", lit("|"), "grep", pattern,
              lit("|"), "grep", "-v", "grep",
              lit("|"), "awk", lit("'{print $2}'"),
              lit("|"), "xargs", "--no-run-if-empty", "kill", f"-{sig}")
    except RemoteError as e:
        if e.exit == 123 and "No such process" in (e.err or ""):
            return  # already exited
        if e.exit == 0:
            return
        raise


def start_daemon(opts: dict, bin: str, *args) -> str:
    """Start a daemon via start-stop-daemon, logging to opts["logfile"];
    returns "started" or "already-running" (`control/util.clj:310-367`).

    Options: env, background (default True), chdir, exec, logfile,
    make-pidfile (default True), match-executable (default True),
    match-process-name (default False), pidfile, process-name.
    """
    e = make_env(opts.get("env"))
    ssd: list = ["--start"]
    if opts.get("background", True):
        ssd += ["--background", "--no-close"]
    if opts.get("pidfile") and opts.get("make-pidfile", True):
        ssd += ["--make-pidfile"]
    if opts.get("match-executable", True):
        ssd += ["--exec", opts.get("exec", bin)]
    if opts.get("match-process-name", False):
        ssd += ["--name", opts.get("process-name",
                                   os.path.basename(bin))]
    if opts.get("pidfile"):
        ssd += ["--pidfile", opts["pidfile"]]
    ssd += ["--chdir", opts["chdir"], "--startas", bin, "--",
            *args, ">>", opts["logfile"], lit("2>&1")]
    log.info("Starting %s", os.path.basename(bin))
    exec_("echo", lit("`date +'%Y-%m-%d %H:%M:%S'`"),
          f"Jepsen starting {escape(e)} {bin} "
          f"{escape(list(args))}", ">>", opts["logfile"])
    try:
        exec_(*( [e] if e else [] ), "start-stop-daemon", *ssd)
        return "started"
    except RemoteError as err:
        if err.exit == 1:
            return "already-running"
        raise


def stop_daemon(pidfile: str | None, cmd: str | None = None) -> None:
    """Kill a daemon by pidfile, or by command name
    (`control/util.clj:369-384`)."""
    if cmd is not None:
        log.info("Stopping %s", cmd)
        meh(lambda: exec_("killall", "-9", "-w", cmd))
        if pidfile:
            meh(lambda: exec_("rm", "-rf", pidfile))
        return
    if pidfile and exists(pidfile):
        log.info("Stopping %s", pidfile)
        try:
            pid = int(exec_("cat", pidfile))
        except (ValueError, RemoteError):
            pid = None  # empty/vanished pidfile: best-effort teardown
        if pid is not None:
            meh(lambda: exec_("kill", "-9", pid))
        meh(lambda: exec_("rm", "-rf", pidfile))


def daemon_running(pidfile: str):
    """True if pidfile's process is alive, None if no pidfile, False if
    the process is gone (`control/util.clj:386-397`)."""
    pid = meh(lambda: exec_("cat", pidfile))
    if not pid:
        return None
    try:
        exec_("ps", "-o", "pid=", "-p", pid)
        return True
    except RemoteError:
        return False


def signal(process_name: str, sig) -> str:
    """Send a signal to a named process (`control/util.clj:399-403`)."""
    meh(lambda: exec_("pkill", "--signal", str(sig), process_name))
    return "signaled"
