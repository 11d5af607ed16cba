// abcq: native job-queue worker pool for external (black-box) simulators.
//
// Replacement for the reference's two host-side distribution
// mechanisms (SURVEY 2 "parallelism strategies"):
//   - the SQLite claim/writeback protocol (reference src/AbcSmc.cpp:877-965:
//     BEGIN EXCLUSIVE claim of Q/R jobs ordered by (status, attempts),
//     status-guarded idempotent writeback), and
//   - the AbcMPI master-worker dynamic load balancer (reference
//     src/AbcMPI.cpp:8-99: self-scheduling first-come-first-served dispatch).
// Here both collapse into one C++ pool: claim a batch from SQLite, fork/exec
// one child per free worker slot, feed the next particle to whichever child
// exits first (dynamic balancing), parse whitespace-separated metric doubles
// from the child's stdout, write back incrementally (each completion commits,
// so a crash loses at most in-flight work - strictly better than the
// reference's end-of-batch writeback).
//
// The build links the system libsqlite3.so directly; the minimal prototype
// subset below replaces the absent sqlite3.h dev header.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <sys/wait.h>
#include <sys/time.h>
#include <unistd.h>
#include <fcntl.h>
#include <poll.h>
#include <errno.h>
#include <time.h>

// --------------------------------------------------------------------------
// minimal sqlite3 C API (subset; ABI-stable since 3.x)
// --------------------------------------------------------------------------
extern "C" {
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
typedef long long sqlite3_int64;

int sqlite3_open(const char*, sqlite3**);
int sqlite3_close(sqlite3*);
int sqlite3_exec(sqlite3*, const char*, int (*)(void*, int, char**, char**),
                 void*, char**);
int sqlite3_prepare_v2(sqlite3*, const char*, int, sqlite3_stmt**,
                       const char**);
int sqlite3_step(sqlite3_stmt*);
int sqlite3_finalize(sqlite3_stmt*);
int sqlite3_column_count(sqlite3_stmt*);
double sqlite3_column_double(sqlite3_stmt*, int);
sqlite3_int64 sqlite3_column_int64(sqlite3_stmt*, int);
const unsigned char* sqlite3_column_text(sqlite3_stmt*, int);
int sqlite3_busy_timeout(sqlite3*, int);
int sqlite3_changes(sqlite3*);
const char* sqlite3_errmsg(sqlite3*);
void sqlite3_free(void*);
}

#define SQLITE_OK 0
#define SQLITE_ROW 100
#define SQLITE_DONE 101

namespace {

struct Job {
    long long serial = -1;
    unsigned long long seed = 0;
    std::vector<double> pars;
};

struct Runner {
    pid_t pid = -1;
    int fd = -1;          // read end of child's stdout
    int job_idx = -1;     // index into jobs vector
    std::string buf;      // accumulated stdout
    double t_start = 0.0;
    long long epoch_start = 0;
};

double now_s() {
    struct timeval tv;
    gettimeofday(&tv, nullptr);
    return tv.tv_sec + 1e-6 * tv.tv_usec;
}

bool exec_sql(sqlite3* db, const std::string& sql, std::string* err = nullptr) {
    char* emsg = nullptr;
    int rc = sqlite3_exec(db, sql.c_str(), nullptr, nullptr, &emsg);
    if (rc != SQLITE_OK) {
        if (err && emsg) *err = emsg;
        if (emsg) sqlite3_free(emsg);
        return false;
    }
    return true;
}

// fetch the par/met column names (everything after serial[,seed])
std::vector<std::string> table_columns(sqlite3* db, const char* table,
                                       int skip) {
    std::vector<std::string> names;
    std::string q = std::string("pragma table_info(") + table + ")";
    sqlite3_stmt* st = nullptr;
    if (sqlite3_prepare_v2(db, q.c_str(), -1, &st, nullptr) != SQLITE_OK)
        return names;
    int i = 0;
    while (sqlite3_step(st) == SQLITE_ROW) {
        if (i++ >= skip)
            names.emplace_back(
                reinterpret_cast<const char*>(sqlite3_column_text(st, 1)));
    }
    sqlite3_finalize(st);
    return names;
}

bool table_exists(sqlite3* db, const char* table) {
    std::string q =
        std::string("select count(*) from sqlite_master where type='table' "
                    "and name='") + table + "'";
    sqlite3_stmt* st = nullptr;
    if (sqlite3_prepare_v2(db, q.c_str(), -1, &st, nullptr) != SQLITE_OK)
        return false;
    bool ok = sqlite3_step(st) == SQLITE_ROW &&
              sqlite3_column_int64(st, 0) > 0;
    sqlite3_finalize(st);
    return ok;
}

// Claim up to n jobs: BEGIN EXCLUSIVE; select Q/R ordered by status, attempts;
// mark R, attempts+1 (reference src/AbcSmc.cpp:877-929, 979-991).
bool claim_jobs(sqlite3* db, int n, std::vector<Job>* jobs, int verbose) {
    std::string par_table = table_exists(db, "upar") ? "upar" : "par";
    std::vector<std::string> par_cols = table_columns(db, par_table.c_str(), 2);
    if (par_cols.empty()) return false;

    std::string sel = "select J.serial, P.seed";
    for (auto& c : par_cols) sel += ", P." + c;
    sel += " from " + par_table + " P, job J where P.serial = J.serial and "
           "(J.status = 'Q' or J.status = 'R') order by J.status, J.attempts";
    if (n >= 0) sel += " limit " + std::to_string(n);

    if (!exec_sql(db, "BEGIN EXCLUSIVE;")) return false;
    sqlite3_stmt* st = nullptr;
    if (sqlite3_prepare_v2(db, sel.c_str(), -1, &st, nullptr) != SQLITE_OK) {
        exec_sql(db, "ROLLBACK;");
        return false;
    }
    while (sqlite3_step(st) == SQLITE_ROW) {
        Job j;
        j.serial = sqlite3_column_int64(st, 0);
        const unsigned char* seedtxt = sqlite3_column_text(st, 1);
        j.seed = seedtxt ? strtoull(
            reinterpret_cast<const char*>(seedtxt), nullptr, 10) : 0;
        for (size_t c = 0; c < par_cols.size(); ++c)
            j.pars.push_back(sqlite3_column_double(st, (int)(2 + c)));
        jobs->push_back(j);
    }
    sqlite3_finalize(st);
    long long now = (long long)time(nullptr);
    for (auto& j : *jobs) {
        std::string up = "update job set startTime = " + std::to_string(now) +
                         ", status = 'R', attempts = attempts + 1 where "
                         "serial = " + std::to_string(j.serial) + ";";
        if (!exec_sql(db, up)) {
            exec_sql(db, "ROLLBACK;");
            return false;
        }
    }
    if (!exec_sql(db, "COMMIT;")) return false;
    if (verbose)
        fprintf(stderr, "[abcq] claimed %zu jobs\n", jobs->size());
    return true;
}

// status-guarded writeback of one finished job (reference
// src/AbcSmc.cpp:932-965, 1016-1031), committed immediately.
bool writeback(sqlite3* db, const std::vector<std::string>& met_cols,
               const Job& job, const std::vector<double>& mets,
               long long epoch_start, double duration) {
    std::string ser = std::to_string(job.serial);
    std::string up = "update met set ";
    char buf[64];
    for (size_t i = 0; i < met_cols.size(); ++i) {
        snprintf(buf, sizeof buf, "%.17g", mets[i]);
        up += met_cols[i] + " = " + buf;
        if (i + 1 < met_cols.size()) up += ", ";
    }
    up += " where serial = " + ser + " and (select (status = 'R' or status = "
          "'Q' or status = 'P') from job J where J.serial = " + ser + ");";
    snprintf(buf, sizeof buf, "%.6f", duration);
    std::string upj = "update job set startTime = " +
                      std::to_string(epoch_start) + ", duration = " + buf +
                      ", status = 'D' where serial = " + ser +
                      " and (status = 'R' or status = 'Q' or status = 'P');";
    if (!exec_sql(db, "BEGIN EXCLUSIVE;")) return false;
    if (!exec_sql(db, up) || !exec_sql(db, upj)) {
        exec_sql(db, "ROLLBACK;");
        return false;
    }
    // status-guarded UPDATE may match 0 rows when another worker already
    // completed this job (at-least-once overlap): commit either way, but
    // only count writebacks that actually landed
    int landed = sqlite3_changes(db);
    if (!exec_sql(db, "COMMIT;")) return false;
    return landed > 0;
}

// launch one child: /bin/sh -c "command p1 p2 ..." with stdout piped
bool launch(Runner* r, const std::string& command, const Job& job,
            int job_idx) {
    int fds[2];
    if (pipe(fds) != 0) return false;
    std::string cmd = command;
    char buf[64];
    for (double p : job.pars) {
        snprintf(buf, sizeof buf, " %.17g", p);
        cmd += buf;
    }
    pid_t pid = fork();
    if (pid < 0) {
        close(fds[0]);
        close(fds[1]);
        return false;
    }
    if (pid == 0) {
        dup2(fds[1], STDOUT_FILENO);
        close(fds[0]);
        close(fds[1]);
        std::string seed_env = std::to_string(job.seed);
        std::string serial_env = std::to_string(job.serial);
        setenv("ABC_RNG_SEED", seed_env.c_str(), 1);
        setenv("ABC_SERIAL", serial_env.c_str(), 1);
        execl("/bin/sh", "sh", "-c", cmd.c_str(), (char*)nullptr);
        _exit(127);
    }
    close(fds[1]);
    fcntl(fds[0], F_SETFL, O_NONBLOCK);
    r->pid = pid;
    r->fd = fds[0];
    r->job_idx = job_idx;
    r->buf.clear();
    r->t_start = now_s();
    r->epoch_start = (long long)time(nullptr);
    return true;
}

bool parse_metrics(const std::string& out, size_t nmet,
                   std::vector<double>* mets) {
    const char* p = out.c_str();
    char* end = nullptr;
    while (true) {
        double v = strtod(p, &end);
        if (end == p) break;
        mets->push_back(v);
        p = end;
    }
    return mets->size() == nmet;
}

}  // namespace

extern "C" {

// Claim up to n_jobs jobs from db_path, run `command p1 p2 ...` on a pool of
// n_workers processes with dynamic load balancing, write metrics back.
// Returns the number of jobs completed successfully, or a negative code:
//   -1 open failed, -2 claim failed, -3 schema missing.
int abcq_run(const char* db_path, const char* command, int n_jobs,
             int n_workers, int verbose) {
    sqlite3* db = nullptr;
    if (sqlite3_open(db_path, &db) != SQLITE_OK) return -1;
    sqlite3_busy_timeout(db, 60000);  // sqdb sleep-retry equivalent

    if (!table_exists(db, "job") || !table_exists(db, "met")) {
        sqlite3_close(db);
        return -3;
    }
    std::vector<std::string> met_cols = table_columns(db, "met", 1);

    std::vector<Job> jobs;
    if (!claim_jobs(db, n_jobs, &jobs, verbose)) {
        sqlite3_close(db);
        return -2;
    }
    if (jobs.empty()) {
        sqlite3_close(db);
        return 0;
    }

    if (n_workers < 1) n_workers = 1;
    std::vector<Runner> pool((size_t)n_workers);
    size_t next_job = 0;
    int completed = 0;
    int in_flight = 0;

    // seed the pool (AbcMPI scheduler seeding, src/AbcMPI.cpp:28-40)
    for (auto& r : pool) {
        if (next_job >= jobs.size()) break;
        if (launch(&r, command, jobs[next_job], (int)next_job)) {
            ++next_job;
            ++in_flight;
        }
    }

    while (in_flight > 0) {
        std::vector<struct pollfd> pfds;
        std::vector<int> slot_of;
        for (size_t s = 0; s < pool.size(); ++s) {
            if (pool[s].pid > 0) {
                pfds.push_back({pool[s].fd, POLLIN, 0});
                slot_of.push_back((int)s);
            }
        }
        int rc = poll(pfds.data(), pfds.size(), 1000);
        if (rc < 0 && errno != EINTR) break;

        for (size_t i = 0; i < pfds.size(); ++i) {
            Runner& r = pool[(size_t)slot_of[i]];
            if (!(pfds[i].revents & (POLLIN | POLLHUP))) continue;
            char chunk[4096];
            ssize_t got;
            bool eof = false;
            while ((got = read(r.fd, chunk, sizeof chunk)) > 0)
                r.buf.append(chunk, (size_t)got);
            if (got == 0) eof = true;
            if (!eof) continue;

            // child finished: reap, parse, write back, refill the slot
            int status = 0;
            waitpid(r.pid, &status, 0);
            close(r.fd);
            double duration = now_s() - r.t_start;
            const Job& job = jobs[(size_t)r.job_idx];
            std::vector<double> mets;
            bool ok = WIFEXITED(status) && WEXITSTATUS(status) == 0 &&
                      parse_metrics(r.buf, met_cols.size(), &mets);
            if (ok) {
                if (writeback(db, met_cols, job, mets, r.epoch_start,
                              duration))
                    ++completed;
            } else if (verbose) {
                fprintf(stderr,
                        "[abcq] job serial=%lld failed (exit=%d, metrics "
                        "parsed=%zu/%zu) - left 'R' for retry\n",
                        job.serial, WIFEXITED(status) ? WEXITSTATUS(status)
                                                      : -1,
                        mets.size(), met_cols.size());
            }
            r.pid = -1;
            r.fd = -1;
            --in_flight;
            if (next_job < jobs.size()) {
                if (launch(&r, command, jobs[next_job], (int)next_job)) {
                    ++next_job;
                    ++in_flight;
                }
            }
        }
    }

    sqlite3_close(db);
    return completed;
}

const char* abcq_version() { return "abcq 0.1.0"; }

}  // extern "C"
