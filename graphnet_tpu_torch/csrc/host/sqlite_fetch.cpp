// SQLite rows straight into a float64 buffer, for the SQLite dataset's
// batched fetch.
//
// Python's sqlite3 route (fetchall() + np.asarray) makes a float object
// for every cell inside a tuple and unboxes it again.  This steps the
// query through the SQLite C API and writes each numeric cell into a
// caller-provided buffer: no Python objects, and no GIL (ctypes releases
// it for the call), so a pool of loader threads fetches in parallel.
// Each call prepares and finalizes its own statement; a connection is
// used by one thread at a time (the dataset keeps one per thread).
//
// Only libsqlite3.so.0 is needed at link time, not sqlite3.h: the few
// functions of the (stable) C interface used here are declared below.

extern "C" {
typedef struct sqlite3 sqlite3;
typedef struct sqlite3_stmt sqlite3_stmt;
int sqlite3_open_v2(const char*, sqlite3**, int, const char*);
int sqlite3_close(sqlite3*);
int sqlite3_prepare_v2(sqlite3*, const char*, int, sqlite3_stmt**,
                       const char**);
int sqlite3_step(sqlite3_stmt*);
int sqlite3_finalize(sqlite3_stmt*);
int sqlite3_column_count(sqlite3_stmt*);
int sqlite3_column_type(sqlite3_stmt*, int);
double sqlite3_column_double(sqlite3_stmt*, int);
}

static const int kSqliteOk = 0;
static const int kSqliteRow = 100;
static const int kSqliteDone = 101;
static const int kSqliteOpenReadonly = 1;
static const int kSqliteInteger = 1;
static const int kSqliteFloat = 2;

extern "C" {

// Open a read-only connection; nullptr on failure.
void* gn_sqlite_open(const char* path) {
  sqlite3* db = nullptr;
  if (sqlite3_open_v2(path, &db, kSqliteOpenReadonly, nullptr) !=
      kSqliteOk) {
    if (db) sqlite3_close(db);
    return nullptr;
  }
  return db;
}

void gn_sqlite_close(void* db) {
  if (db) sqlite3_close(static_cast<sqlite3*>(db));
}

// Run `sql`, writing its numeric cells row-major into
// out[cap_rows * ncols].  Returns:
//   >= 0        the number of rows written
//   -1          a prepare or step error, or not ncols columns
//   -2          a non-numeric cell (NULL, TEXT, BLOB): the caller takes
//               the Python route
//   -(n + 3)    the buffer is too small; n = the rows the query yields
long long gn_sqlite_fetch_f64(void* dbv, const char* sql, double* out,
                              long long cap_rows, int ncols) {
  sqlite3* db = static_cast<sqlite3*>(dbv);
  sqlite3_stmt* stmt = nullptr;
  if (sqlite3_prepare_v2(db, sql, -1, &stmt, nullptr) != kSqliteOk) {
    if (stmt) sqlite3_finalize(stmt);
    return -1;
  }
  if (sqlite3_column_count(stmt) != ncols) {
    sqlite3_finalize(stmt);
    return -1;
  }
  long long rows = 0;
  int rc;
  while ((rc = sqlite3_step(stmt)) == kSqliteRow) {
    if (rows < cap_rows) {
      double* dst = out + rows * ncols;
      for (int c = 0; c < ncols; ++c) {
        const int t = sqlite3_column_type(stmt, c);
        if (t != kSqliteInteger && t != kSqliteFloat) {
          sqlite3_finalize(stmt);
          return -2;
        }
        dst[c] = sqlite3_column_double(stmt, c);
      }
    }
    ++rows;
  }
  sqlite3_finalize(stmt);
  if (rc != kSqliteDone) return -1;
  if (rows > cap_rows) return -(rows + 3);
  return rows;
}

}  // extern "C"
